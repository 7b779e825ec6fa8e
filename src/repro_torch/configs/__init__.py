"""Model configurations: the paper's CLOES cascade (`configs.cloes`) and
the LLM architecture zoo behind the neural final stage.

Every zoo module exposes CONFIG (the full assigned architecture) and SMOKE
(a reduced same-family variant: <=2 layers, d_model<=512) used by the CPU
tests. `get(name)` / `get_smoke(name)` are the public API. The port
carries the dense family (gemma3, qwen3, yi, starcoder2, pixtral); the
moe, ssm, hybrid and encdec families are not ported yet, and asking for
one raises NotImplementedError.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_1p2b", "dbrx_132b", "yi_34b", "rwkv6_1p6b", "arctic_480b",
    "qwen3_8b", "gemma3_27b", "seamless_m4t_large_v2", "pixtral_12b",
    "starcoder2_3b",
]

# canonical ids as assigned (dashes/dots) -> module names
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "dbrx-132b": "dbrx_132b",
    "yi-34b": "yi_34b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "arctic-480b": "arctic_480b",
    "qwen3-8b": "qwen3_8b",
    "gemma3-27b": "gemma3_27b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "pixtral-12b": "pixtral_12b",
    "starcoder2-3b": "starcoder2_3b",
}

# module -> family, for the architectures whose family is not ported yet
_NOT_PORTED = {
    "zamba2_1p2b": "hybrid", "dbrx_132b": "moe", "rwkv6_1p6b": "ssm",
    "arctic_480b": "moe", "seamless_m4t_large_v2": "encdec",
}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod in _NOT_PORTED:
        raise NotImplementedError(
            f"{name}: the {_NOT_PORTED[mod]} family is not ported to "
            "PyTorch yet (ROADMAP Queue 1 item 12); the port serves the "
            "dense family")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_archs() -> list[str]:
    return list(ALIASES.keys())

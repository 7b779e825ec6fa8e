"""The cascade's NEURAL FINAL STAGE: a zoo model with a scalar value head
that re-scores the items surviving the linear cascade — how the paper
treats the expensive "Deep & Wide" feature (Table 1, cost 0.84): a costly
scorer that the cascade shields from the bulk of the traffic.

The scorer runs the model's blocks over the window schedule: a dense
architecture, as in the reference, or a moe one (the port's addition: the
reference's scorer runs the dense block alone, so a moe model does not
score there); a moe block's aux loss is dropped. An encdec model scores
as in the reference: its decoder layers' self attention and MLP over the
item tokens, with no encoder and no cross attention. The ssm and hybrid
families cannot score (the reference's scorer cannot run them either):
asking for one raises ValueError before a weight is drawn.

CascadeServer is the thin COMPATIBILITY SHIM over the streaming
serving.session.CascadeSession engine: submit() queues unboundedly and
serve() drains everything, in submit order — new code should use
CascadeSession directly (deadlines, admission control, flush policy,
degraded modes). The two give the same results on the same request set.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core import cascade as C
from repro_torch.core import losses as L
from repro_torch.models import base as MB
from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as Z
from repro_torch.serving.batching import (RankRequest, RankResponse,
                                          RequestBatcher)
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         ServingConfig)


# ---------------------------------------------------------------------------
# Neural final stage: zoo model + mean-pool value head over item "token"
# encodings. Item features are quantized into the model's vocab — a stand-in
# tokenizer (the real system embeds item text/ids; the *compute* is real).
# ---------------------------------------------------------------------------

SCORING_FAMILIES = ("dense", "moe", "encdec")


def check_scorable(cfg: MB.ModelConfig) -> None:
    """Raise ValueError unless cfg's family runs the scorer's blocks."""
    if cfg.arch_type not in SCORING_FAMILIES:
        raise ValueError(
            f"{cfg.name}: the {cfg.arch_type} family cannot be the neural "
            f"final stage; the scorer runs the {', '.join(SCORING_FAMILIES)}"
            " families' attention blocks, as the reference's runs the dense "
            "block")


@dataclasses.dataclass
class NeuralScorer:
    cfg: MB.ModelConfig
    params: dict
    head: torch.Tensor           # (d_model,)
    tokens_per_item: int = 8

    @classmethod
    def create(cls, cfg: MB.ModelConfig, seed: int, *,
               tokens_per_item: int = 8, device="cuda") -> "NeuralScorer":
        """Random weights on `device`, by the reference's init rule, from
        a torch generator seeded with `seed` (the reference draws from
        `jax.random`, so the numbers differ)."""
        check_scorable(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = MB.materialize(Z.templates(cfg), gen, dtype=torch.float32)
        # small head: an untrained final stage should perturb, not
        # dominate, the calibrated cascade score
        head = 0.002 * torch.randn((cfg.d_model,), generator=gen,
                                   device=gen.device)
        return cls(cfg=cfg, params=params, head=head,
                   tokens_per_item=tokens_per_item)

    @property
    def device(self) -> torch.device:
        return self.head.device

    def tokenize(self, feats: torch.Tensor) -> torch.Tensor:
        """(N, d_x) -> (N, tokens_per_item) int64 by feature quantization."""
        n, d = feats.shape
        t = self.tokens_per_item
        take = (feats[:, :t] if d >= t
                else torch.nn.functional.pad(feats, (0, t - d)))
        quant = torch.clamp((take + 4.0) / 8.0 * (self.cfg.vocab - 1), 0,
                            self.cfg.vocab - 1)
        return quant.to(torch.int64)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        """(N, d_x) -> (N,) scalar relevance scores: mean-pooled final
        hidden state through the value head."""
        hidden = self._hidden(self.tokenize(feats))
        return hidden.mean(dim=1) @ self.head

    def _hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        check_scorable(self.cfg)
        params = self.params
        x = params["embed"][tokens]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        wins = Z.window_schedule(self.cfg)
        for i, p in enumerate(MB.unstack(params["blocks"],
                                         self.cfg.n_layers)):
            x, _, _ = Z._block_fwd(p, self.cfg, x, positions, int(wins[i]))
        return Lyr.rms_norm(x, params["final_norm"])


# ---------------------------------------------------------------------------
# The cascade server.
# ---------------------------------------------------------------------------

class CascadeServer:
    """Thin compatibility shim over serving.session.CascadeSession:
    unbounded queue, no deadlines, no degradation — submit() then serve()
    drains everything in submit order, exactly the pre-session API. Serves
    on `device` (default the CUDA card; asking for it without one
    raises)."""

    def __init__(self, params: C.Params, cfg: C.CascadeConfig,
                 lcfg: L.LossConfig | None = None,
                 neural_stage: NeuralScorer | None = None,
                 neural_cost: float = 0.84,
                 use_fused_kernel: bool | None = None,
                 fused: str | None = None,
                 batcher: RequestBatcher | None = None,
                 device="cuda"):
        # fused names a core.pipeline.PLANS entry directly ('filter' — the
        # fully fused kernel, 'score' — the batched scorer + the stage
        # chain, 'none' — the plain PyTorch path). use_fused_kernel is the
        # pre-registry bool API, deprecated for one release of aliasing;
        # an explicit fused= always takes precedence over the legacy bool.
        if use_fused_kernel is not None:
            warnings.warn(
                "CascadeServer(use_fused_kernel=...) is deprecated; pass "
                "fused='filter' (True) or fused='none' (False) — a "
                "core.pipeline.PLANS plan name — instead",
                DeprecationWarning, stacklevel=2)
            if fused is None:
                fused = "filter" if use_fused_kernel else "none"
        self.fused = fused if fused is not None else "filter"
        self.use_fused_kernel = self.fused == "filter"
        self.batcher = batcher if batcher is not None else RequestBatcher()
        self.session = CascadeSession(
            params, cfg, lcfg, neural_stage=neural_stage, device=device,
            scfg=ServingConfig(
                plan=self.fused,
                group_buckets=tuple(self.batcher.buckets),
                batch_groups=self.batcher.batch_groups,
                max_queue=None,                        # legacy: unbounded
                degrade=DegradePolicy(high_watermark=None),
                neural_cost=neural_cost))
        self.params = self.session.params
        self.cfg = cfg
        self.lcfg = self.session.lcfg
        self.neural = neural_stage
        self.neural_cost = neural_cost
        self._futures = []

    @property
    def _rank(self):
        """The session's pipeline."""
        return self.session._rank

    def rank_batch(self, batch: dict) -> dict:
        """Run the hard-cascade pipeline on a padded batch (device
        tensors out; `session.fetch` reads them)."""
        return self.session.rank_batch(batch)

    def warmup(self) -> list[tuple[int, int]]:
        """Run the pipeline once for every batcher shape bucket."""
        return self.session.warmup()

    # -- request API ------------------------------------------------------

    def submit(self, req: RankRequest) -> None:
        self._futures.append(self.session.submit(req))

    def serve(self) -> list[RankResponse]:
        # The session flushes bucket by bucket (shape order, not submit
        # order); the futures list restores submit order before return.
        self.session.flush()
        futures, self._futures = self._futures, []
        return [f.result() for f in futures]

"""The cascade's NEURAL FINAL STAGE: a zoo model with a scalar value head
that re-scores the items surviving the linear cascade — how the paper
treats the expensive "Deep & Wide" feature (Table 1, cost 0.84): a costly
scorer that the cascade shields from the bulk of the traffic.

The port of `NeuralScorer` from the reference's
src/repro/serving/cascade_server.py. Its `CascadeServer` compatibility
shim over CascadeSession is not ported yet (ROADMAP Queue 1 item 8). The
scorer runs the dense block over the window schedule, so, as in the
reference, its model is a dense architecture.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import base as MB
from repro_torch.models import layers as Lyr
from repro_torch.models import zoo as Z


# ---------------------------------------------------------------------------
# Neural final stage: zoo model + mean-pool value head over item "token"
# encodings. Item features are quantized into the model's vocab — a stand-in
# tokenizer (the real system embeds item text/ids; the *compute* is real).
# ---------------------------------------------------------------------------

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
        params = self.params
        x = params["embed"][tokens]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        wins = Z.window_schedule(self.cfg)
        for i, p in enumerate(MB.unstack(params["blocks"],
                                         self.cfg.n_layers)):
            x, _ = Z._dense_block_fwd(p, self.cfg, x, positions,
                                      int(wins[i]))
        return Lyr.rms_norm(x, params["final_norm"])

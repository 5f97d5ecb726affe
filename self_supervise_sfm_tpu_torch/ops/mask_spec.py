"""Structured attention-mask specifications.

Port of ``self_supervise_sfm_tpu/ops/mask_spec.py``. The aggregator's masks
are block-structured: query tokens see [the whole compressed scene context ‖
their own frame]. A dense (Nq, Nk) boolean tensor costs O(N^2) memory and
blocks tile skipping, so the mask is described symbolically: the dense
attention path materialises it; the flash kernels (forward and backward)
never evaluate it per element, but walk work tiles that start and end at
its segments (the context, each frame).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RelocMask:
    """KV axis = [n_ctx context tokens ‖ num_frames * frame_size query tokens].

    Query row r (frame r // frame_size) attends every context token and its
    own frame's tokens only.
    """

    n_ctx: int
    frame_size: int
    num_frames: int

    @property
    def nq(self) -> int:
        return self.num_frames * self.frame_size

    @property
    def nk(self) -> int:
        return self.n_ctx + self.nq

    def materialize(self, device=None) -> torch.Tensor:
        """Dense (1, 1, Nq, Nk) boolean allow-mask for the dense path."""
        q_frame = torch.arange(self.nq, device=device) // self.frame_size
        qq = q_frame[:, None] == q_frame[None, :]
        ctx = torch.ones((self.nq, self.n_ctx), dtype=torch.bool, device=device)
        return torch.cat([ctx, qq], dim=1)[None, None]

    def allowed(self, q_idx, k_idx):
        """Elementwise allow predicate on global (row, col) indices (Python
        ints or integer tensors; ``//`` floors for both)."""
        same_frame = (k_idx - self.n_ctx) // self.frame_size == (
            q_idx // self.frame_size
        )
        return (k_idx < self.n_ctx) | ((k_idx >= self.n_ctx) & same_frame)

    def block_visible(self, q0, q1, k0, k1):
        """Whether tile [q0, q1) x [k0, k1) contains ANY allowed entry."""
        ctx_hit = k0 < self.n_ctx
        fq0 = q0 // self.frame_size
        fq1 = (q1 - 1) // self.frame_size
        fk0 = (k0 - self.n_ctx) // self.frame_size
        fk1 = (k1 - 1 - self.n_ctx) // self.frame_size
        overlap = (fk0 <= fq1) & (fq0 <= fk1) & (k1 > self.n_ctx)
        return ctx_hit | overlap

"""Bank localization: `rel_vecs[bank_map]` — port of
gtos_tpu/ops/localize.py.

The localized encoder gathers the GRU's relation vectors into per-graph
banks once per encoder stack. The gather's backward is a scatter-add of
the [B*P_loc, D] cotangent into [P, D]. Training batches carry the sort
order of that scatter (`build_localize_aux`: `loc_perm`, `loc_bnd`, array
for array the JAX package's), and with them the backward is the JAX
package's scatter-free form: the cotangent rows in bank-row order, an f32
prefix sum, and each row's total as the difference of its run's bounds.
On an H100 it measures faster than autograd of the gather (an index_put
with accumulation, which serializes the long run of pad slots on bank
row 0) at the c2 training shapes (PERF.md, chip_smoke.py `[localize]`).
Without the arrays (serving batches) it is the gather's autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the host side (numpy) lives with batchify, so that the data layer
# imports no torch
from gtos_tpu_torch.data.batching import build_localize_aux  # noqa: F401


def sorted_segment_sum(g: torch.Tensor, loc_perm: torch.Tensor,
                       loc_bnd: torch.Tensor, block: int = 128
                       ) -> torch.Tensor:
    """The localize gather's backward from its sort order: g [B, P_loc, D]
    -> [P, D] in g's dtype, each bank row the f32 sum of the cotangent
    rows of its slots. The prefix sum is blocked (a scan within each
    `block` rows, then an exclusive scan of the block totals), so both
    scans are short and run in parallel: one scan over all B*P_loc rows
    would walk them one after another."""
    D = g.shape[-1]
    rows = g.reshape(-1, D)[loc_perm.long()].float()
    rows = F.pad(rows, (0, 0, 0, -rows.shape[0] % block)).view(-1, block, D)
    within = rows.cumsum(1)
    totals = within[:, -1]
    cum = (within + (totals.cumsum(0) - totals)[:, None]).reshape(-1, D)
    cum = torch.cat([cum.new_zeros(1, D), cum])
    return (cum[loc_bnd[1].long()] - cum[loc_bnd[0].long()]).to(g.dtype)


class _SortedLocalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rel_vecs, bank_map, loc_perm, loc_bnd):
        ctx.save_for_backward(loc_perm, loc_bnd)
        return rel_vecs[bank_map.long()]

    @staticmethod
    def backward(ctx, g):
        loc_perm, loc_bnd = ctx.saved_tensors
        return sorted_segment_sum(g, loc_perm, loc_bnd), None, None, None


def localize_bank(rel_vecs: torch.Tensor, bank_map: torch.Tensor,
                  loc_perm: Optional[torch.Tensor] = None,
                  loc_bnd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rel_vecs [P, D], bank_map [B, P_loc] int -> [B, P_loc, D]; with the
    batch's loc_perm/loc_bnd the backward is `sorted_segment_sum`."""
    if loc_perm is None or loc_bnd is None:
        return rel_vecs[bank_map.long()]
    return _SortedLocalize.apply(rel_vecs, bank_map, loc_perm, loc_bnd)

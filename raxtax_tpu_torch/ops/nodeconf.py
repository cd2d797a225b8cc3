"""Significance compaction on exact f64 confidences.

Only what the exact path needs of the JAX package's ``ops/nodeconf.py``: the
unit/wide split (``_compact_unit_wide`` without the overflow sideband) and
the plain eval-node variant (``_compact_dd_from_cum``). The JAX versions
select on an f32 approximation with ``top_k`` into fixed-width slots and
recompute exact values afterwards; in eager PyTorch the threshold is taken
on the exact f64 values and ``torch.nonzero`` compacts them, so there is no
slot width to outgrow and no re-run. Entry order within a query differs from
the JAX package's (ascending position here, descending value there); the
host evaluation sorts its input and does not depend on it.

Host contract (unchanged): per query a slice of ``(idx, conf)`` pairs, where
``idx >= 0`` is an eval-node position and ``idx <= -2`` codes a unit tip as
``-(tip + 2)``, to be expanded into all unit eval nodes of that tip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: device-side significance threshold: raw confidence that could round to
#: >= 0.01 at 2 decimals, with a little slack below the 0.005 cutoff. The
#: host re-rounds and prunes, so extras are harmless.
SIG_THRESHOLD = 0.005 - 1e-4


@dataclass
class SignificantSet:
    """Threshold masks queued on the device; :meth:`pull` compacts them,
    reads the exact values at the selected nodes and copies the result to
    the host (the only host synchronisation of the significance stage)."""

    cum: torch.Tensor  #: [B, Np+1] exact prefix sums
    #: list of (mask [B, n] bool, starts [n], ends [n], codes [n]), int64
    parts: list

    def pull(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(off int64 [B+1], idx int32 [total], conf float64 [total])``:
        query b owns ``[off[b], off[b+1])``; within a query the parts keep
        their order (wide nodes first, then unit tips)."""
        B = self.cum.shape[0]
        rows, codes, vals = [], [], []
        for mask, starts, ends, code in self.parts:
            r, j = torch.nonzero(mask, as_tuple=True)
            rows.append(r)
            codes.append(code[j])
            vals.append(self.cum[r, ends[j]] - self.cum[r, starts[j]])
        rows = torch.cat(rows)
        codes = torch.cat(codes)
        vals = torch.cat(vals)
        order = torch.argsort(rows, stable=True)
        counts = torch.bincount(rows, minlength=B)
        off = np.zeros(B + 1, np.int64)
        np.cumsum(counts.cpu().numpy(), out=off[1:])
        return (
            off,
            codes[order].to(torch.int32).cpu().numpy(),
            vals[order].cpu().numpy(),
        )


def compact_unit_wide(
    cum: torch.Tensor,  # [B, Np+1] zero-prefixed exact tip cumsum
    wide_starts: torch.Tensor,  # [n_w]
    wide_ends: torch.Tensor,  # [n_w]
    wide_pos: torch.Tensor,  # [n_w] eval positions of the wide nodes
    tip_has_unit: torch.Tensor,  # [num_tips] bool: tip hosts >= 1 unit node
    num_tips: int,
) -> SignificantSet:
    """WIDE eval nodes (range > 1) through two boundary gathers of the
    cumsum; UNIT nodes (range 1) through the difference of neighbouring
    prefix sums, once per tip, coded ``-(tip + 2)``. A unit node's
    confidence is ``fl64(cum[t+1] - cum[t])`` as the reference computes it —
    not the tip's own probability, which differs from it by the rounding of
    the running sum."""
    n_p = cum.shape[1] - 1
    dev = cum.device
    ws, we = wide_starts.long(), wide_ends.long()
    conf_w = cum[:, we] - cum[:, ws]
    has_unit = torch.zeros(n_p, dtype=torch.bool, device=dev)
    has_unit[:num_tips] = tip_has_unit
    mask_t = ((cum[:, 1:] - cum[:, :-1]) >= SIG_THRESHOLD) & has_unit[None, :]
    tips = torch.arange(n_p, device=dev)
    return SignificantSet(
        cum=cum,
        parts=[
            (conf_w >= SIG_THRESHOLD, ws, we, wide_pos.long()),
            (mask_t, tips, tips + 1, -(tips + 2)),
        ],
    )


def compact_eval_nodes(
    cum: torch.Tensor,  # [B, Np+1]
    starts: torch.Tensor,  # [J] eval-node range starts
    ends: torch.Tensor,  # [J]
) -> SignificantSet:
    """Every eval node through the two boundary gathers; ``idx`` is the eval
    position."""
    s, e = starts.long(), ends.long()
    conf = cum[:, e] - cum[:, s]
    pos = torch.arange(s.shape[0], device=cum.device)
    return SignificantSet(
        cum=cum, parts=[(conf >= SIG_THRESHOLD, s, e, pos)]
    )

"""Edge layouts: padded adjacency index maps for the sparse decoders.

The reference scans the full dense H row/column on every message update
(/root/reference/lib/ldpc_decoder_cb_impl.cc:349-376 etc.). The batched
decoders instead store messages per *edge* in two padded layouts:

  check-major  (B, M, Wr): slot (m, w) holds the edge to variable chk_nbrs[m, w]
  var-major    (B, N, Wc): slot (j, v) holds the edge to check   var_nbrs[j, v]

with Wr = max row weight, Wc = max column weight (3 for all shipped codes).
Switching between the two layouts is a static-index gather over the flattened
edge array (pad slots index one past the end and read 0), so both the check
and variable updates are contiguous reductions over a tiny trailing axis.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..codes import LdpcCode

__all__ = ["EdgeLayout", "edge_layout"]


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    M: int
    N: int
    Wr: int
    Wc: int
    # padded adjacency (sentinels: N for chk_nbrs, M for var_nbrs)
    chk_nbrs: np.ndarray      # (M, Wr) int32, variable index per check slot
    var_nbrs: np.ndarray      # (N, Wc) int32, check index per variable slot
    chk_mask: np.ndarray      # (M, Wr) bool, True where a real edge
    var_mask: np.ndarray      # (N, Wc) bool
    # flat cross-layout gathers (pads index the slot past the end)
    cm_from_vm: np.ndarray    # (M, Wr) int32 -> index into flat var-major (N*Wc+1)
    vm_from_cm: np.ndarray    # (N, Wc) int32 -> index into flat check-major (M*Wr+1)


@functools.lru_cache(maxsize=None)
def edge_layout(code: LdpcCode) -> EdgeLayout:
    H = code.H
    M, N = H.shape
    chk = code.chk_nbrs
    var = code.var_nbrs
    Wr, Wc = chk.shape[1], var.shape[1]

    chk_mask = chk < N
    var_mask = var < M

    # slot lookup tables
    cm_slot = {}  # (m, j) -> w
    for m in range(M):
        for w in range(Wr):
            if chk_mask[m, w]:
                cm_slot[(m, int(chk[m, w]))] = w
    vm_slot = {}  # (j, m) -> v
    for j in range(N):
        for v in range(Wc):
            if var_mask[j, v]:
                vm_slot[(j, int(var[j, v]))] = v

    vm_from_cm = np.full((N, Wc), M * Wr, dtype=np.int32)
    for j in range(N):
        for v in range(Wc):
            if var_mask[j, v]:
                m = int(var[j, v])
                vm_from_cm[j, v] = m * Wr + cm_slot[(m, j)]
    cm_from_vm = np.full((M, Wr), N * Wc, dtype=np.int32)
    for m in range(M):
        for w in range(Wr):
            if chk_mask[m, w]:
                j = int(chk[m, w])
                cm_from_vm[m, w] = j * Wc + vm_slot[(j, m)]

    return EdgeLayout(
        M=M, N=N, Wr=Wr, Wc=Wc,
        chk_nbrs=chk.astype(np.int32), var_nbrs=var.astype(np.int32),
        chk_mask=chk_mask, var_mask=var_mask,
        cm_from_vm=cm_from_vm, vm_from_cm=vm_from_cm,
    )

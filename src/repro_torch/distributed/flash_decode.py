"""Distributed flash-decoding: KV-sequence-sharded one-token attention.

Counterpart of `repro.distributed.flash_decode`. For long-context decode
(the `long_500k` cell: batch 1, KV 524,288) the batch axis cannot absorb
the `data` mesh axis, so the KV *sequence* is sharded instead. Each rank
computes a partial online-softmax triple (m, l, acc) over its KV slice;
the combine is three small collectives (one max, two sums) of O(B*H*D),
the distributed analogue of split-K flash-decoding. A rank whose slice
holds no valid key floors its max at -1e30, so its exp factor is 0.

q is replicated; k and v are DTensors sharded on S over `seq_axis` (or
plain full tensors, the same on every rank, of which each rank takes its
slice). The output is replicated (a DTensor when k is one).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import axis_sizes

Tensor = torch.Tensor


def decode_partial(q: Tensor, k: Tensor, v: Tensor, length, start: int,
                   axes: list) -> Tensor:
    """The body on one rank's KV slice [start, start + S_loc), combined
    over the process groups `axes` whose ranks hold the other slices."""
    b, _, hq, d = q.shape
    s_loc, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    qh = q[:, 0].reshape(b, hkv, g, d).to(f32)
    s = torch.matmul(qh, k.to(f32).permute(0, 2, 3, 1)) / d ** 0.5  # (b, hkv, g, S_loc)
    pos = start + torch.arange(s_loc, device=q.device)[None, None, None, :]
    ln = torch.as_tensor(length, device=q.device)
    valid = pos < ln
    s = s.masked_fill(~valid, float("-inf"))
    m_loc = torch.clamp_min(s.amax(dim=-1, keepdim=True), -1e30)  # rank with no valid keys
    p = torch.exp(s - m_loc).masked_fill(~valid, 0.0)
    l_loc = p.sum(dim=-1, keepdim=True)
    acc_loc = torch.matmul(p.to(v.dtype).to(f32), v.to(f32).transpose(1, 2))  # (b, hkv, g, d)
    # exact combine across shards
    m = m_loc
    for axis in axes:
        m = col.pmax(m, axis)
    corr = torch.exp(m_loc - m)
    l, acc = l_loc * corr, acc_loc * corr
    for axis in axes:
        l, acc = col.psum(l, axis), col.psum(acc, axis)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, 1, hq, d).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """Flash-decode bound to a mesh. KV sharded over `seq_axis`."""

    mesh: Any  # DeviceMesh
    seq_axis: str = "data"

    def decode_attention(self, q: Tensor, k: Tensor, v: Tensor, length) -> Tensor:
        """q (B, 1, Hq, D) replicated; k/v (B, S, Hkv, D) sharded on S.
        length: number of valid cache entries (an int or a scalar tensor)."""
        names = tuple(self.mesh.mesh_dim_names)
        ax = names.index(self.seq_axis)
        n = axis_sizes(self.mesh)[self.seq_axis]
        s_global = k.shape[1]
        if s_global % n:
            raise ValueError(f"{s_global} cache entries do not split over {n} ranks")
        group = self.mesh.get_group(self.seq_axis)
        r = col.axis_index(group)
        rep = [Replicate()] * self.mesh.ndim
        kv_pl = list(rep)
        kv_pl[ax] = Shard(1)
        dt = isinstance(k, DTensor)

        def local(t: Tensor, placements) -> Tensor:
            if isinstance(t, DTensor):
                return t.redistribute(self.mesh, placements).to_local()
            if placements is rep:
                return t
            s_loc = s_global // n
            return t[:, r * s_loc:(r + 1) * s_loc]

        if isinstance(length, DTensor):
            length = length.full_tensor()
        out = decode_partial(local(q, rep), local(k, kv_pl), local(v, kv_pl), length,
                             r * (s_global // n), [group])
        if dt:
            return DTensor.from_local(out, self.mesh, rep, run_check=False)
        return out


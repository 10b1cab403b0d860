"""KV cache with optional int8 quantization.

Counterpart of `repro.models.kv_cache`. The int8 path stores K/V as int8
with a per (position, kv-head) float32 scale: a symmetric linear
quantizer, the paper's hybrid-quantization principle (Table 1) applied to
the LM substrate. Both frameworks round half to even, so the int8 codes
match the reference bitwise.

Layout: (B, Smax, Hkv, D), sequence-major as in the reference.

Unlike the reference, whose arrays are immutable, the write functions
update the cache's tensors IN PLACE and return the same `KVCache`: a
decode step then moves one token's K/V instead of copying the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import shard_offset

Tensor = torch.Tensor


class KVCache(NamedTuple):
    k: Tensor  # (B, Smax, Hkv, D) bf16, or int8 when quantized
    v: Tensor
    k_scale: Tensor | None = None  # (B, Smax, Hkv, 1) float32 when quantized
    v_scale: Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(batch: int, max_len: int, n_kv: int, d_head: int, *,
               quantized: bool = False, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (batch, max_len, n_kv, d_head)
    if quantized:
        def zeros(s, dt):
            return torch.zeros(s, dtype=dt, device=device)

        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       k_scale=zeros((batch, max_len, n_kv, 1), torch.float32),
                       v_scale=zeros((batch, max_len, n_kv, 1), torch.float32))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _quantize(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 per (pos, head): x ~= q * scale."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = amax / 127.0
    q = torch.round(xf / torch.clamp_min(scale, 1e-12))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q: Tensor, scale: Tensor, dtype=torch.bfloat16) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _fields(cache: KVCache, k_new: Tensor, v_new: Tensor):
    """(destination, new values) pairs, quantizing when the cache is int8."""
    if cache.quantized:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        return ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                (cache.v_scale, vs))
    return (cache.k, k_new), (cache.v, v_new)


def _write_local(dst: DTensor, new: Tensor, pos: int) -> None:
    """`dst[:, pos:pos + S_new] = new` for a DTensor cache, on each rank's
    own shard: the new rows in the cache's batch layout, written where
    they fall in the rank's slice of the sequence."""
    mesh = dst.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in dst.placements]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    rows = new.redistribute(mesh, pl).to_local()
    local = dst.to_local()
    off = shard_offset(dst, 1)
    lo, hi = max(pos, off), min(pos + rows.shape[1], off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = rows[:, lo - pos:hi - pos].to(local.dtype)


def write_cache(cache: KVCache, k_new: Tensor, v_new: Tensor, pos: int) -> KVCache:
    """Insert (B, S_new, Hkv, D) at sequence offset `pos`, in place.

    `pos` is clamped so the update fits, as `dynamic_update_slice` does.
    A DTensor cache (on a mesh) is written shard by shard."""
    s_new, smax = k_new.shape[1], cache.k.shape[1]
    pos = max(0, min(int(pos), smax - s_new))
    for dst, new in _fields(cache, k_new, v_new):
        if isinstance(dst, DTensor):
            _write_local(dst, new, pos)
        else:
            dst[:, pos:pos + s_new] = new.to(dst.dtype)
    return cache


def write_cache_batched(cache: KVCache, k_new: Tensor, v_new: Tensor,
                        pos: Tensor) -> KVCache:
    """Insert one token per slot at per-slot positions `pos` (B,), in place.

    Where the reference takes a one-hot masked pass over the whole cache,
    this writes one row per slot; a slot whose position lies past the
    cache's end is left unchanged, as the one-hot leaves it."""
    b, smax = cache.k.shape[:2]
    rows = torch.arange(b, device=pos.device)
    inside = (pos < smax)[:, None, None]
    at = torch.clamp(pos, max=smax - 1)
    for dst, new in _fields(cache, k_new, v_new):
        dst[rows, at] = torch.where(inside, new[:, 0].to(dst.dtype), dst[rows, at])
    return cache


def read_cache(cache: KVCache, dtype=torch.bfloat16) -> tuple[Tensor, Tensor]:
    """Materialize dequantized K, V (full length; the mask handles validity)."""
    if cache.quantized:
        return (dequantize(cache.k, cache.k_scale, dtype),
                dequantize(cache.v, cache.v_scale, dtype))
    return cache.k, cache.v


def cache_bytes(cache: KVCache) -> int:
    return sum(t.numel() * t.element_size() for t in cache if t is not None)

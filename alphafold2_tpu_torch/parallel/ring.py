"""Ring attention over `torch.distributed` (counterpart of
`alphafold2_tpu/parallel/ring.py`): exact attention over a sequence axis
sharded across ranks, with the K/V shards rotated around the ring.

Each step folds one K/V block into an online-softmax accumulator
(`_block_attend`, fp32), then every rank hands its block to the next
rank of the axis (`shift`, one `batch_isend_irecv`). The shift is a
`torch.autograd.Function` whose backward is the inverse shift, as
`ppermute`'s transpose is, so the ring trains under `backward()`.
Memory per rank is O(L / n) for K/V while the result is exact softmax
attention (Liu et al. 2023, "Ring Attention with Blockwise
Transformers").

The block attention is plain PyTorch, as the JAX ring is plain XLA
outside any Pallas kernel; a kernel variant that returns its row
statistics is a candidate for later work.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from alphafold2_tpu_torch.parallel.mesh import Mesh
from alphafold2_tpu_torch.parallel.sharding import (P, active_mesh,
                                                    local_call)


def _exchange(tensors: Sequence[torch.Tensor], send_to: Optional[int],
              recv_from: Optional[int], group) -> list:
    """Send `tensors` to global rank `send_to` and receive same-shaped
    ones from `recv_from` (zeros where there is no sender)."""
    outs = [torch.zeros(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), send_to,
                                  group))
        if recv_from is not None:
            ops.append(dist.P2POp(dist.irecv, o, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _Shift(torch.autograd.Function):
    """Every rank of `axis` sends its tensors `offset` ranks on and
    receives from `offset` ranks back; the backward sends the gradients
    the other way. Without `cyclic`, the ends of the axis send or
    receive nothing (the pipeline's stage hop)."""

    @staticmethod
    def forward(ctx, mesh, axis, offset, cyclic, *tensors):
        ctx.route = (mesh, axis, offset, cyclic)
        return tuple(_exchange(
            tensors, mesh.neighbour(axis, offset, cyclic),
            mesh.neighbour(axis, -offset, cyclic), mesh.group(axis)))

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, offset, cyclic = ctx.route
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        back = _exchange(grads, mesh.neighbour(axis, -offset, cyclic),
                         mesh.neighbour(axis, offset, cyclic),
                         mesh.group(axis))
        return (None, None, None, None) + tuple(back)


def shift(mesh: Mesh, axis: str, *tensors, offset: int = 1,
          cyclic: bool = True):
    """`ppermute` by `offset` along `axis` (differentiable)."""
    if mesh.shape[axis] <= 1:
        return tensors
    return _Shift.apply(mesh, axis, offset, cyclic, *tensors)


def _block_attend(q, k, v, bias, acc, row_max, row_sum):
    """One blockwise online-softmax update.

    q: (b, h, nq, d); k/v: (b, h, nk, d); bias: broadcastable to
    (b, h, nq, nk) or None; acc: (b, h, nq, d) running weighted sum;
    row_max/row_sum: (b, h, nq). Returns updated (acc, row_max, row_sum).
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if bias is not None:
        logits = logits + bias
    new_max = torch.maximum(row_max, logits.amax(-1))
    correction = torch.exp(row_max - new_max)
    p = torch.exp(logits - new_max[..., None])
    acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                     p, v)
    row_sum = row_sum * correction + p.sum(-1)
    return acc, new_max, row_sum


def ring_attention(q, k, v, axis_name: str, bias=None, mask=None,
                   mesh: Optional[Mesh] = None):
    """Exact attention where each rank holds one K/V shard of `axis_name`
    (local tensors, inside `local_call` or an SPMD program).

    q: (b, h, nq_local, d), pre-scaled; k/v: (b, h, nk_local, d);
    bias: (b, h, nq_local, nk_GLOBAL); mask: (b, nk_GLOBAL) key
    validity. `mesh` defaults to the active one."""
    mesh = mesh or active_mesh()
    n_shards = mesh.shape[axis_name]
    my_idx = mesh.coord(axis_name)
    nk = k.shape[-2]
    b, h, nq, d = q.shape
    acc = q.new_zeros((b, h, nq, d), dtype=torch.float32)
    row_max = q.new_full((b, h, nq), -float("inf"), dtype=torch.float32)
    row_sum = q.new_zeros((b, h, nq), dtype=torch.float32)
    k_cur, v_cur = k, v
    for step in range(n_shards):
        shard = (my_idx - step) % n_shards
        blk_bias = None
        if bias is not None:
            blk_bias = bias[..., shard * nk:(shard + 1) * nk].float()
        if mask is not None:
            key_ok = mask[:, shard * nk:(shard + 1) * nk]
            mbias = torch.where(key_ok[:, None, None, :], 0.0, -1e9)
            blk_bias = mbias if blk_bias is None else blk_bias + mbias
        acc, row_max, row_sum = _block_attend(
            q.float(), k_cur.float(), v_cur.float(), blk_bias, acc,
            row_max, row_sum)
        if step < n_shards - 1:
            k_cur, v_cur = shift(mesh, axis_name, k_cur, v_cur)
    out = acc / torch.clamp(row_sum[..., None], min=1e-30)
    return out.to(q.dtype)


def _seed_of(key, *coords) -> int:
    """A 63-bit generator seed from the base key and rank coordinates."""
    text = ",".join(str(int(c)) for c in (key,) + coords)
    return int.from_bytes(hashlib.blake2b(text.encode(),
                                          digest_size=8).digest(),
                          "little") >> 1


def _keep_mask(key, coords, shard, rate, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(
        _seed_of(key, *coords, shard))
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def pair_row_dropout_mask(key, rate: float, *, b: int, h: int,
                          j_blocks: int, il: int, jl: int,
                          i_blocks: Optional[int] = 1,
                          data_coord: Optional[int] = None,
                          device="cpu") -> torch.Tensor:
    """Dense replay of the ring's dropout masks: the full
    (b, h, I, J_q, J_k) keep mask that a run of
    `pair_row_attention_sharded` with the same `key` draws.
    `i_blocks=None` mirrors an unsharded row axis (no i coordinate);
    an int mirrors an ``i`` axis of that size."""
    rows = []
    for ic in range(i_blocks or 1):
        cols = []
        for jc in range(j_blocks):
            coords = [] if data_coord is None else [data_coord]
            coords += ([] if i_blocks is None else [ic]) + [jc]
            cols.append(torch.cat([
                _keep_mask(key, coords, ks, rate, (b, h, il, jl, jl),
                           device) for ks in range(j_blocks)], dim=-1))
        rows.append(torch.cat(cols, dim=-2))
    return torch.cat(rows, dim=2)


def pair_row_attention_sharded(q, k, v, bias, mesh: Mesh,
                               i_axis: Optional[str] = "i",
                               j_axis: str = "j", mask=None,
                               data_axis: Optional[str] = "data",
                               dropout_rate: float = 0.0,
                               dropout_key: Optional[int] = None):
    """Row attention over the J axis of a sharded 2-D map, ring-parallel.

    q/k/v: (b, h, I, J, d) global values (plain or DTensor), q
    pre-scaled, placed P(data, -, i, j, -); within each row, cells
    attend along J with the edge bias bias[j_query, j_key] (b, h, J, J),
    the same for every row. The bias is placed by its QUERY axis over
    ``j`` with the key axis whole (one J_local x J panel per rank); each
    ring step slices the key block it needs. `mask` (b, I, J) is per-row
    key validity, placed P(data, i, -) and sliced along the key axis
    each step, so non-separable masks hold exactly. `i_axis=None`: rows
    unsharded (the MSA track). `data_axis` keeps the batch sharded.

    Dropout (`dropout_rate` > 0, `dropout_key` an int seed) runs inside
    the ring: each rank derives one generator per key shard from the key
    and its (data, i, j) coordinates and drops the unnormalised softmax
    numerator, while `row_sum` accumulates undropped: the dense
    `dropout(softmax(logits)) @ v` with 1 / (1 - rate) scaling. Returns
    a DTensor placed like q."""
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("pair_row_attention_sharded: dropout_rate > 0 "
                         "requires dropout_key")

    def ax(name, dim=None):
        if name is None or name not in mesh.shape:
            return None
        if dim is not None and dim % mesh.shape[name] != 0:
            return None   # e.g. batch=1 on a data=2 training mesh
        return name

    da, ia = ax(data_axis, q.shape[0]), ax(i_axis)
    spec = P(da, None, ia, j_axis, None)
    bias_spec = P(da, None, j_axis, None)
    mask_spec = P(da, ia, None)
    has_drop = dropout_rate > 0.0
    coords = [mesh.coord(a) for a in (da, ia) if a] + \
        [mesh.coord(j_axis)]

    def kernel(qi, ki, vi, bi, mi):
        b, h, il, jl, d = qi.shape
        n_shards = mesh.shape[j_axis]
        my_idx = mesh.coord(j_axis)
        qf = qi.float()
        acc = qf.new_zeros((b, h, il, jl, d))
        row_max = qf.new_full((b, h, il, jl), -float("inf"))
        row_sum = qf.new_zeros((b, h, il, jl))
        k_cur, v_cur = ki, vi
        for step in range(n_shards):
            shard = (my_idx - step) % n_shards
            logits = torch.einsum("bhiqd,bhikd->bhiqk", qf, k_cur.float())
            if bi is not None:
                blk = bi[..., shard * jl:(shard + 1) * jl].float()
                logits = logits + blk[:, :, None]
            if mi is not None:
                key_ok = mi[..., shard * jl:(shard + 1) * jl]
                logits = torch.where(key_ok[:, None, :, None, :], logits,
                                     torch.full_like(logits, -1e9))
            new_max = torch.maximum(row_max, logits.amax(-1))
            corr = torch.exp(row_max - new_max)
            p = torch.exp(logits - new_max[..., None])
            p_av = p
            if has_drop:
                # drop the numerator only: row_sum stays undropped
                keep = _keep_mask(dropout_key, coords, shard, dropout_rate,
                                  p.shape, p.device)
                p_av = p * keep / (1.0 - dropout_rate)
            acc = acc * corr[..., None] + torch.einsum(
                "bhiqk,bhikd->bhiqd", p_av, v_cur.float())
            row_sum = row_sum * corr + p.sum(-1)
            row_max = new_max
            if step < n_shards - 1:
                k_cur, v_cur = shift(mesh, j_axis, k_cur, v_cur)
        out = acc / torch.clamp(row_sum[..., None], min=1e-30)
        return out.to(qi.dtype)

    return local_call(kernel, mesh, (q, k, v, bias, mask),
                      (spec, spec, spec, bias_spec, mask_spec), spec)


def ring_attention_sharded(q, k, v, mesh: Mesh, axis: str, bias=None,
                           mask=None):
    """Place q/k/v (b, h, n, d) (and the bias rows) over `axis` on the
    sequence dim and run the ring; the result comes back as a DTensor
    placed the same way."""
    seq = P(None, None, axis, None)

    def kernel(qi, ki, vi, bi, mi):
        return ring_attention(qi, ki, vi, axis, bias=bi, mask=mi,
                              mesh=mesh)

    return local_call(kernel, mesh, (q, k, v, bias, mask),
                      (seq, seq, seq, seq, P(None, None)), seq)

"""K2 and K3: paged attention over a block-table-indexed K/V page pool.

The ports of ``paged_attention_decode`` (one query token per sequence)
and ``paged_attention_prefill`` (the chunked-prefill supertile: s >= 1
query tokens at true positions, int8 pools dequantised on gather).
Layouts are the JAX package's:

* ``q``            (b, h, d) for decode, (b, s, h, d) for prefill,
* ``k_pages``/``v_pages`` (kv_heads, num_pages, page_size, head_dim),
* ``block_table``  (b, pages_per_seq) int32 page ids, null page 0 in
  the unused tail,
* ``start``        (b,) int32 absolute position of query token 0,
* ``lengths``      (b,) int32 valid tokens including the new ones,
* ``k_scale``/``v_scale`` (kv_heads, num_pages, page_size, 1) bf16 for
  int8 pools.

Each wrapper launches its CUDA kernel (``csrc/paged_attention_*.cu``)
for CUDA tensors and runs the plain version for CPU tensors.  The plain
versions walk the pages in order with the kernels' online softmax, page
skip and masking constants (``NEG_INF = -2**30``, ``l`` clamped at
``1e-30``, probabilities cast to the V dtype before the PV product), so
on the CPU they reproduce the reference kernels' arithmetic.

Each kernel has two designs, picked by a fixed rule in its C entry, which
returns the code of the one it ran; ``wrapper.design`` names the design of
the last launch.  K2: ``split-kv`` for bf16 pools (head_dim 64 or 128),
else ``cuda-core``; K3: ``wgmma`` for bf16 q over bf16 or int8 pools
(head_dim 64, 128 or 256), else ``cuda-core``.  Both new designs may split
each sequence's pages over CTAs and merge the partials in the same launch:
the wrapper hands them an fp32 workspace and per-(kv head, sequence[,
chunk]) counters, both cached per device and reused by every launch (the
kernels run in stream order; the last CTA of each group resets its
counter).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -(2.0**30)
MAX_PAGE_SIZE = 64
MAX_HEAD_DIM = 256
MAX_CHUNK_ROWS = 64  # K3: query rows (tokens x group) one CTA holds: wgmma's M

#: the designs by the code their C entries return
DECODE_DESIGNS = ("cuda-core", "split-kv")
PREFILL_DESIGNS = ("cuda-core", "wgmma")
#: (kernel, device) -> the split-KV fp32 workspace / int32 counters, grown on demand
_WORKSPACE: dict[tuple[str, torch.device], torch.Tensor] = {}
_COUNTERS: dict[tuple[str, torch.device], torch.Tensor] = {}
_MIN_COUNTERS = 4096

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _online_pages(q5, k_pages, v_pages, block_table, qpos, lengths, last_pos, *,
                  softcap, k_scale=None, v_scale=None):
    """Page-by-page online softmax, shared by both plain versions.

    ``q5`` (b, kvh, R, d) query rows, ``qpos`` (b, R) their absolute
    positions, ``last_pos`` (b,) the causal page bound (a page starting
    past it is skipped, like one starting at or past ``lengths``)."""
    b, kvh, rows, d = q5.shape
    ps = k_pages.shape[2]
    scale = 1.0 / math.sqrt(d)
    v_dtype = torch.bfloat16 if k_scale is not None else v_pages.dtype
    table = block_table.long()
    lengths = lengths.long()
    qf = q5.float()
    m = torch.full((b, kvh, rows, 1), NEG_INF, dtype=torch.float32, device=q5.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, rows, d), dtype=torch.float32, device=q5.device)
    slot = torch.arange(ps, device=q5.device)
    for p in range(table.shape[1]):
        ids = table[:, p]
        k = k_pages[:, ids].transpose(0, 1)  # (b, kvh, ps, d)
        v = v_pages[:, ids].transpose(0, 1)
        if k_scale is not None:  # dequant-on-gather: int8 * scale in fp32 -> bf16
            k = (k.float() * k_scale[:, ids].transpose(0, 1).float()).to(torch.bfloat16)
            v = (v.float() * v_scale[:, ids].transpose(0, 1).float()).to(torch.bfloat16)
        s = (qf @ k.float().transpose(-1, -2)) * scale  # (b, kvh, R, ps)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = p * ps + slot
        mask = (kpos[None, None, :] < lengths[:, None, None]) \
            & (kpos[None, None, :] <= qpos[:, :, None])  # (b, R, ps)
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s - m_new)
        live = ((p * ps < lengths) & (p * ps <= last_pos))[:, None, None, None]
        l = torch.where(live, l * alpha + pr.sum(dim=-1, keepdim=True), l)
        pv = pr.to(v_dtype).float() @ v.float()
        acc = torch.where(live, acc * alpha + pv, acc)
        m = torch.where(live, m_new, m)
    return acc / torch.clamp(l, min=1e-30)


def paged_attention_decode_plain(q, k_pages, v_pages, block_table, start, lengths, *,
                                 softcap=None):
    """K2 in plain PyTorch: q (b, h, d) -> (b, h, d)."""
    b, h, d = q.shape
    kvh = k_pages.shape[0]
    group = h // kvh
    start = start.long()
    qpos = start[:, None].expand(b, group)
    out = _online_pages(q.reshape(b, kvh, group, d), k_pages, v_pages, block_table,
                        qpos, lengths, lengths.long(), softcap=softcap)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_prefill_plain(q, k_pages, v_pages, block_table, start, lengths, *,
                                  k_scale=None, v_scale=None, softcap=None):
    """K3 in plain PyTorch: q (b, s, h, d) -> (b, s, h, d), one query chunk."""
    b, s, h, d = q.shape
    kvh = k_pages.shape[0]
    group = h // kvh
    start = start.long()
    q5 = q.reshape(b, s, kvh, group, d).permute(0, 2, 1, 3, 4).reshape(b, kvh, s * group, d)
    tok = torch.arange(s, device=q.device).repeat_interleave(group)  # row -> token
    qpos = start[:, None] + tok[None, :]
    out = _online_pages(q5, k_pages, v_pages, block_table, qpos, lengths, start + s - 1,
                        softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    out = out.reshape(b, kvh, s, group, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, h, d).to(q.dtype)


def _check_common(q, k_pages, v_pages, block_table, start, lengths, h, d):
    kvh, _, ps, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"do not match head_dim {d}")
    if h % kvh:
        raise ValueError(f"n_heads {h} is not a multiple of kv_heads {kvh}")
    if block_table.ndim != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError(f"block_table must be (batch, pages), got {tuple(block_table.shape)}")
    if ps > MAX_PAGE_SIZE or d > MAX_HEAD_DIM:
        raise ValueError(f"kernel supports page_size <= {MAX_PAGE_SIZE} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got {ps} and {d}")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("block_table", block_table),
                    ("start", start), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"paged attention kernels run on CUDA tensors, got {dev}")


def _i32(t):
    return t.to(torch.int32).contiguous()


def _scratch(kernel: str, dev: torch.device, floats: int, counters: int):
    """The device's cached workspace (>= ``floats`` fp32) and zeroed
    counters (>= ``counters`` int32) of ``kernel``; (None, None) when the
    launch does not split."""
    if floats == 0:
        return None, None
    ws = _WORKSPACE.get((kernel, dev))
    if ws is None or ws.numel() < floats:
        ws = _WORKSPACE[(kernel, dev)] = torch.empty(floats, dtype=torch.float32, device=dev)
    cnt = _COUNTERS.get((kernel, dev))
    if cnt is None or cnt.numel() < counters:
        cnt = _COUNTERS[(kernel, dev)] = torch.zeros(max(counters, _MIN_COUNTERS),
                                                     dtype=torch.int32, device=dev)
    return ws, cnt


@functools.lru_cache(maxsize=4096)
def _decode_splits(dtype: int, b: int, kvh: int, ps: int, d: int, width: int) -> int:
    return _build.load("paged_attention_decode").paged_attention_decode_splits(
        dtype, b, kvh, ps, d, width)


@functools.lru_cache(maxsize=4096)
def _prefill_splits(q_dtype: int, kv_dtype: int, b: int, s: int, qc: int, h: int, kvh: int,
                    ps: int, d: int, width: int) -> int:
    return _build.load("paged_attention_prefill").paged_attention_prefill_splits(
        q_dtype, kv_dtype, b, s, qc, h, kvh, ps, d, width)


def _launched(rc: int, name: str) -> int:
    """The design code a C entry returned; raises on minus a cudaError."""
    if rc < 0:
        _build.check(-rc, name)
    return rc


def paged_attention_decode(q, k_pages, v_pages, block_table, start, lengths, *,
                           softcap=None):
    """One decode token per sequence: q (b, h, d) -> (b, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pages, v_pages, block_table, start,
                                            lengths, softcap=softcap)
    b, h, d = q.shape
    _check_common(q, k_pages, v_pages, block_table, start, lengths, h, d)
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"decode kernel needs q and pages of one dtype (bf16 or fp32), got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    kvh, num_pages, ps, _ = k_pages.shape
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    table, start, lengths = _i32(block_table), _i32(start), _i32(lengths)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("paged_attention_decode")
    width, code = table.shape[1], _DTYPE_CODES[q.dtype]
    splits = _decode_splits(code, b, kvh, ps, d, width)
    ws, cnt = _scratch("paged_attention_decode", q.device,
                       splits * b * h * (d + 2) if splits > 1 else 0, b * kvh)
    rc = lib.paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), code,
        table.data_ptr(), start.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
        b, h, kvh, num_pages, ps, d, width, 1.0 / math.sqrt(d),
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_attention_decode.design = DECODE_DESIGNS[_launched(rc, "paged_attention_decode")]
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0  # kernel launches since the last reset
paged_attention_decode.design = None  # the design of the last launch


def prefill_chunk(s: int, group: int) -> int:
    """Query tokens per K3 CTA: as many as fit ``MAX_CHUNK_ROWS`` rows
    (64: one warpgroup's wgmma M)."""
    return max(1, min(s, MAX_CHUNK_ROWS // group))


def paged_attention_prefill(q, k_pages, v_pages, block_table, start, lengths, *,
                            k_scale=None, v_scale=None, softcap=None):
    """Chunked prefill: q (b, s, h, d) at positions start.. -> (b, s, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(q, k_pages, v_pages, block_table, start,
                                             lengths, k_scale=k_scale, v_scale=v_scale,
                                             softcap=softcap)
    b, s, h, d = q.shape
    _check_common(q, k_pages, v_pages, block_table, start, lengths, h, d)
    kvh, num_pages, ps, _ = k_pages.shape
    group = h // kvh
    if group > MAX_CHUNK_ROWS:
        raise ValueError(f"prefill kernel holds at most {MAX_CHUNK_ROWS} rows, group is {group}")
    quant = k_scale is not None
    if quant:
        if q.dtype != torch.bfloat16 or k_pages.dtype != torch.int8 \
                or v_pages.dtype != torch.int8 or v_scale is None \
                or k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16 \
                or tuple(k_scale.shape) != (kvh, num_pages, ps, 1) \
                or tuple(v_scale.shape) != tuple(k_scale.shape):
            raise TypeError("int8 pools need bf16 q, int8 pages and bf16 scales of shape "
                            "(kv_heads, num_pages, page_size, 1)")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    elif q.dtype not in (torch.float32, torch.bfloat16) or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"prefill kernel needs q and pages of one dtype (bf16 or fp32), got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    table, start, lengths = _i32(block_table), _i32(start), _i32(lengths)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    lib = _build.load("paged_attention_prefill")
    qc, width = prefill_chunk(s, group), table.shape[1]
    q_code, kv_code = _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype]
    splits = _prefill_splits(q_code, kv_code, b, s, qc, h, kvh, ps, d, width)
    units = b * kvh * -(-s // qc)  # (sequence, kv head, chunk)
    ws, cnt = _scratch("paged_attention_prefill", q.device,
                       splits * units * MAX_CHUNK_ROWS * (d + 2) if splits > 1 else 0, units)
    rc = lib.paged_attention_prefill(
        q.data_ptr(), q_code, k_pages.data_ptr(), v_pages.data_ptr(), kv_code,
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        table.data_ptr(), start.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
        b, s, qc, h, kvh, num_pages, ps, d, width,
        1.0 / math.sqrt(d), 0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_attention_prefill.design = PREFILL_DESIGNS[_launched(rc, "paged_attention_prefill")]
    paged_attention_prefill.launches += 1
    return out


paged_attention_prefill.launches = 0  # kernel launches since the last reset
paged_attention_prefill.design = None  # the design of the last launch

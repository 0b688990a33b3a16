"""Exact lower envelope with winner payload (EDT phases 2 and 3): kernel
wrappers + plain versions.

Counterparts of gie_mapping_tpu/ops/pallas/envelope.py::envelope_packed_pallas,
::envelope_mid_pallas and ::envelope_pallas (with packed_out and one
payload); the CUDA kernels are csrc/envelope.cu (the generic envelope runs
envelope_mid's with one batch row).  All three return the
packed key `best << idx_bits | site` (ties to the smallest site, best capped
at (1 << (31 - idx_bits)) - 1) and the winning site's payload.
"""
from __future__ import annotations

import torch

from . import _build

# the O(N) kernels keep 12 (phase 2) or 16 (phase 3 and the generic
# envelope) bytes per site and lane in shared memory (csrc/envelope.cu);
# the presets' canvases reach N = 240 along x (phase 2) and 168 along z
# (phase 3), their 2-D windows N = 200 along x (the generic envelope)
ENVELOPE_PACKED_MAX_N = 512
ENVELOPE_MID_MAX_N = 384


def env_idx_bits(n: int) -> int:
    """Site-index bit budget of the packed envelope key for an n-site axis."""
    return (n - 1).bit_length() if n > 1 else 1


def _envelope_plain(f: torch.Tensor, pay: torch.Tensor, chunk: int = 8):
    """min over sites (axis 1 of [B, N, L]) of the packed key, then a gather
    of the winner's payload.  f, pay int32 [B, N, L]."""
    B, N, L = f.shape
    ib = env_idx_bits(N)
    cap = (1 << (31 - ib)) - 1
    dev = f.device
    i_idx = torch.arange(N, dtype=torch.int32, device=dev)
    fc = torch.clamp(f, max=cap)[:, None]                      # [B, 1, N, L]
    keys = []
    for x0 in range(0, N, chunk):
        xs = torch.arange(x0, min(x0 + chunk, N), dtype=torch.int32, device=dev)
        dx = xs[:, None] - i_idx[None, :]
        cand = torch.clamp((dx * dx)[None, :, :, None] + fc, max=cap)
        packed = (cand << ib) | i_idx[None, None, :, None]
        keys.append(packed.amin(dim=2))                        # [B, c, L]
    key = torch.cat(keys, dim=1)
    site = (key & ((1 << ib) - 1)).to(torch.int64)
    return key, torch.gather(pay, 1, site)


def envelope_packed_plain(packed: torch.Tensor, yb: int):
    """Plain version of envelope_packed."""
    N = packed.shape[0]
    cap = (1 << (31 - env_idx_bits(N))) - 1
    p = packed.reshape(1, N, -1)
    f = torch.where((p & 1) > 0, p >> (yb + 1), cap)
    key, pay = _envelope_plain(f, p & ((1 << (yb + 1)) - 1))
    return key.reshape(packed.shape), pay.reshape(packed.shape)


def envelope_mid_plain(f: torch.Tensor, pay: torch.Tensor):
    """Plain version of envelope_mid."""
    B, N = f.shape[:2]
    key, p = _envelope_plain(f.reshape(B, N, -1), pay.reshape(B, N, -1))
    return key.reshape(f.shape), p.reshape(f.shape)


def envelope_plain(f: torch.Tensor, pay: torch.Tensor):
    """Plain version of envelope."""
    N = f.shape[0]
    key, p = _envelope_plain(f.reshape(1, N, -1), pay.reshape(1, N, -1))
    return key.reshape(f.shape), p.reshape(f.shape)


def _check(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} wants int32 inputs, got {t.dtype}")
        if t.device != ts[0].device or t.shape != ts[0].shape:
            raise ValueError(f"{name}: inputs differ in device or shape")
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ts[0].device}")


def envelope_packed(packed: torch.Tensor, yb: int):
    """Phase 2: envelope over axis 0 of phase 1's packed word [N, ...].
    f = valid ? word >> (yb+1) : cap; payload = word & ((1 << (yb+1)) - 1).
    Returns (key, payload), each shaped like `packed`.

    CPU tensors take the plain version; CUDA tensors launch the O(N)
    kernel, which takes N <= ENVELOPE_PACKED_MAX_N sites."""
    _check("envelope_packed", packed)
    if packed.device.type == "cpu":
        return envelope_packed_plain(packed, yb)
    N = packed.shape[0]
    if N > ENVELOPE_PACKED_MAX_N:
        raise ValueError(f"envelope_packed: the kernel takes at most "
                         f"{ENVELOPE_PACKED_MAX_N} sites, got {N}")
    L = packed.numel() // max(N, 1)
    src = packed.contiguous()
    key = torch.empty_like(src)
    pay = torch.empty_like(src)
    with _build.on_device_of(src):
        rc = _build.fn("gie_envelope_packed")(
            src.data_ptr(), key.data_ptr(), pay.data_ptr(), N, L, env_idx_bits(N),
            yb, _build.stream_of(src))
    envelope_packed.launches += 1
    _build.check("gie_envelope_packed", rc)
    return key, pay


def envelope_mid(f: torch.Tensor, pay: torch.Tensor):
    """Phase 3: envelope over the middle axis of [B, N, ...] site costs `f`
    (0 <= f; a site at f >= cap never wins) with per-site payload `pay`.
    Returns (key, payload) shaped like `f`.

    CPU tensors take the plain version; CUDA tensors launch the O(N)
    kernel, which takes N <= ENVELOPE_MID_MAX_N sites."""
    _check("envelope_mid", f, pay)
    if f.device.type == "cpu":
        return envelope_mid_plain(f, pay)
    B, N = f.shape[:2]
    if N > ENVELOPE_MID_MAX_N:
        raise ValueError(f"envelope_mid: the kernel takes at most "
                         f"{ENVELOPE_MID_MAX_N} sites, got {N}")
    L = f.numel() // max(B * N, 1)
    fs = f.contiguous()
    ps = pay.contiguous()
    key = torch.empty_like(fs)
    pout = torch.empty_like(fs)
    with _build.on_device_of(fs):
        rc = _build.fn("gie_envelope_mid")(
            fs.data_ptr(), ps.data_ptr(), key.data_ptr(), pout.data_ptr(), B, N,
            L, env_idx_bits(N), _build.stream_of(fs))
    envelope_mid.launches += 1
    _build.check("gie_envelope_mid", rc)
    return key, pout


def envelope(f: torch.Tensor, pay: torch.Tensor):
    """Envelope over axis 0 of [N, ...] site costs `f` (0 <= f; a site at
    f >= cap never wins) with per-site payload `pay`.  Returns (key,
    payload) shaped like `f`.

    CPU tensors take the plain version; CUDA tensors launch envelope_mid's
    O(N) kernel with one batch row, which takes N <= ENVELOPE_MID_MAX_N
    sites."""
    _check("envelope", f, pay)
    if f.device.type == "cpu":
        return envelope_plain(f, pay)
    N = f.shape[0]
    if N > ENVELOPE_MID_MAX_N:
        raise ValueError(f"envelope: the kernel takes at most "
                         f"{ENVELOPE_MID_MAX_N} sites, got {N}")
    L = f.numel() // max(N, 1)
    fs = f.contiguous()
    ps = pay.contiguous()
    key = torch.empty_like(fs)
    pout = torch.empty_like(fs)
    with _build.on_device_of(fs):
        rc = _build.fn("gie_envelope_mid")(
            fs.data_ptr(), ps.data_ptr(), key.data_ptr(), pout.data_ptr(), 1, N,
            L, env_idx_bits(N), _build.stream_of(fs))
    envelope.launches += 1
    _build.check("gie_envelope_mid", rc)
    return key, pout


envelope_packed.launches = 0
envelope_mid.launches = 0
envelope.launches = 0

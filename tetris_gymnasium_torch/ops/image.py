"""The reference CNN workload's resize and grayscale, plain PyTorch.

Port of ``tetris_gymnasium_tpu/ops/image.py`` (``_area_zoom_matrix :49``,
``resize_area_zoom :87``, ``_gray_tables :125``, ``_W22 :146``,
``grayscale_u8 :149``, ``grayscale_u8_exact :176``, ``preprocess_rgb84
:197``), with its own copies of the coefficient table, the gray weights and
the limb tables:

* :func:`resize_area_zoom` is ``cv2.resize(..., INTER_AREA)`` for an
  enlargement in cv2's fixed point: 11-bit coefficients per axis, one pass
  along the width and one along the height, then ``(acc + 2**21) >> 22``
  and a clip to ``[0, 255]``.  The accumulator stays below ``2**31``; the
  passes run as float64 products, which hold every partial sum exactly;
* :func:`grayscale_u8` is ``(r*W0 + g*W1 + b*W2) >> 22`` with 22-bit weights;
* :func:`grayscale_u8_exact` evaluates gymnasium's float64 sum exactly from
  25-bit limbs of ``v * w_c * 2**45``; on CUDA tensors the
  ``grayscale_u8_exact`` kernel (``csrc/gray_exact.cu``) computes it.

On the card the chain from the engine state to the gray frame is the
``render_rgb84`` kernel, which reads the same coefficients as taps from
:func:`area_zoom_taps`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetris_gymnasium_torch.utils.device import constant

_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS

# gymnasium's GrayscaleObservation weights, as 22-bit fixed point
_GRAY_WEIGHTS = (0.2125, 0.7154, 0.0721)
_W22 = tuple(int(round(w * (1 << 22))) for w in _GRAY_WEIGHTS)
_LIMB_BITS = 25
_FRAC_BITS = 45  # every double in [0, 256) is a multiple of 2**-45


@functools.lru_cache(maxsize=None)
def _area_zoom_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """Row-interpolation matrix ``R[n_dst, n_src]`` (int32) of cv2's INTER_AREA zoom.

    The source cell of output ``dx`` is ``floor(dx * scale)`` with ``scale =
    1 / (dst / src)`` in double; the blend fraction ``(dx+1) - (sx+1)*inv``
    is computed in float32, and the two coefficients are rounded
    separately, so a row need not sum to 2048.
    """
    if n_dst < n_src:
        raise ValueError(f"resize_area_zoom only enlarges (src {n_src} -> dst {n_dst})")
    inv = n_dst / n_src
    scale = 1.0 / inv
    dx = np.arange(n_dst)
    s = np.floor(dx * scale).astype(np.int64)
    f = ((dx + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f))
    hi = (s >= n_src - 1) & (f > 0)  # clamp at the right border
    f = np.where(hi, 0, f)
    s = np.where(hi, n_src - 1, s)
    s2 = np.minimum(s + 1, n_src - 1)
    a1 = np.rint((f * np.float32(_COEF_SCALE)).astype(np.float32)).astype(np.int32)
    a0 = np.rint(((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.float32)).astype(np.int32)
    R = np.zeros((n_dst, n_src), dtype=np.int32)
    R[dx, s] += a0
    R[dx, s2] += a1
    return R


@functools.lru_cache(maxsize=None)
def area_zoom_taps(n_src: int, n_dst: int):
    """``(src int32[n_dst, 2], coef int32[n_dst, 2])``: the two taps of each
    output row of :func:`_area_zoom_matrix` (a row has at most two non-zero
    entries; a missing second tap has coefficient 0)."""
    R = _area_zoom_matrix(n_src, n_dst)
    src = np.zeros((n_dst, 2), dtype=np.int32)
    coef = np.zeros((n_dst, 2), dtype=np.int32)
    for d in range(n_dst):
        nz = np.nonzero(R[d])[0]
        if len(nz) > 2:
            raise AssertionError(f"row {d} of the {n_src}->{n_dst} zoom has {len(nz)} taps")
        for t, c in enumerate(nz):
            src[d, t], coef[d, t] = c, R[d, c]
        if len(nz) < 2:
            src[d, len(nz):] = nz[0] if len(nz) else 0
    return src, coef


def resize_area_zoom(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(img, (out_w, out_h), INTER_AREA)`` for a uint8 enlargement.

    ``img`` is ``[..., H, W]`` or ``[..., H, W, C]`` with ``C`` in (1, 3, 4);
    returns uint8 of the same rank with the spatial sizes replaced.
    """
    has_c = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    H, W = (img.shape[-3], img.shape[-2]) if has_c else (img.shape[-2], img.shape[-1])
    Rx = constant(_area_zoom_matrix(W, out_w), img.device, torch.float64)
    Ry = constant(_area_zoom_matrix(H, out_h), img.device, torch.float64)
    x = img.to(torch.float64)
    if has_c:
        h = torch.einsum("...hwc,Ww->...hWc", x, Rx)  # scaled 2048
        acc = torch.einsum("...hWc,Hh->...HWc", h, Ry)  # scaled 2048**2
    else:
        h = torch.einsum("...hw,Ww->...hW", x, Rx)
        acc = torch.einsum("...hW,Hh->...HW", h, Ry)
    out = (acc.to(torch.int64) + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return out.clamp(0, 255).to(torch.uint8)


def grayscale_u8(rgb: torch.Tensor) -> torch.Tensor:
    """gymnasium's ``GrayscaleObservation`` in 22-bit fixed point: ``[..., 3] uint8 -> [...] uint8``."""
    acc = None
    for c in range(3):
        t = rgb[..., c].to(torch.int32) * _W22[c]
        acc = t if acc is None else acc + t
    return (acc >> 22).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _gray_tables():
    """Per-channel scaled-integer tables ``(hi int32[3, 256], lo int32[3, 256])``:
    ``v * w_c`` in float64 (what gymnasium computes) times ``2**45`` is an
    integer below ``2**53``, split into a high limb (``>> 25``) and a low one."""
    v = np.arange(256, dtype=np.float64)
    hi, lo = [], []
    for w in _GRAY_WEIGHTS:
        t = np.round((v * w) * float(2**_FRAC_BITS)).astype(np.int64)
        hi.append(t >> _LIMB_BITS)
        lo.append(t & ((1 << _LIMB_BITS) - 1))
    return np.stack(hi).astype(np.int32), np.stack(lo).astype(np.int32)


def grayscale_u8_exact_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grayscale_u8_exact`, on any device."""
    hi_t, lo_t = (constant(t, rgb.device) for t in _gray_tables())
    hi = lo = None
    for c in range(3):
        idx = rgb[..., c].long()
        h, l = hi_t[c][idx], lo_t[c][idx]
        hi = h if hi is None else hi + h
        lo = l if lo is None else lo + l
    total_hi = hi + (lo >> _LIMB_BITS)
    return (total_hi >> (_FRAC_BITS - _LIMB_BITS)).to(torch.uint8)


def grayscale_u8_exact(rgb: torch.Tensor) -> torch.Tensor:
    """gymnasium's float64 gray formula, exactly: ``[..., 3] uint8 -> [...] uint8``.

    Differs from numpy's float64 value only where numpy's own sequential
    additions round onto an integer (164 of the 2**24 RGB triples, by the
    JAX package's count).  On CUDA tensors the ``grayscale_u8_exact``
    kernel computes it."""
    if rgb.is_cuda:
        from tetris_gymnasium_torch import kernels

        return kernels.grayscale_u8_exact(rgb)
    return grayscale_u8_exact_plain(rgb)


def preprocess_rgb84(rgb: torch.Tensor, out_h: int = 84, out_w: int = 84) -> torch.Tensor:
    """The reference chain's resize and grayscale: ``[..., H, W, 3] -> [..., out_h, out_w]`` uint8."""
    return grayscale_u8(resize_area_zoom(rgb, out_h, out_w))

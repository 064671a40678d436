"""MOSSE correlation-filter tracker with a DSST-style scale search, on
``torch.fft`` (counterpart of ``vfloodnet_tpu.ops.tracker``).

The filter (Bolme et al., CVPR 2010) is learned against a Gaussian
response at a fixed 64 x 64 working window; each frame it is evaluated on
window crops at scales {1/step, 1, step} (and, with ``search_rot``, small
rotations), the crop with the best peak-to-sidelobe ratio (PSR) wins, and
the filter is updated only when that PSR passes a gate. The window crop,
its resize to 64 x 64 and the affine augmentations of the first frame run
as torch ops on the tracker's device, where the JAX package uses OpenCV:
the resize is ``F.interpolate`` bilinear with half-pixel centres (as
``cv2.resize`` with ``INTER_LINEAR``), the augmentations and rotated crops
are a :class:`..ops.homography.BilinearMap` of the inverse affine map (as
``cv2.warpAffine`` with ``BORDER_REFLECT`` and ``BORDER_REPLICATE``). The
augmentation angles and scales come from ``np.random.default_rng(seed)``
in the JAX package's order. The PSR gate reads three numbers per candidate
to the host each frame.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .homography import BilinearMap

SIZE = 64          # working window
_REG = 1e-5        # filter regulariser
_SIGMA = 2.0       # target response sigma (window units)


def _hann2d() -> np.ndarray:
    w = np.hanning(SIZE).astype(np.float32)
    return w[:, None] * w[None, :]


def _gauss_target() -> np.ndarray:
    c = SIZE // 2
    y, x = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    return np.exp(-((x - c) ** 2 + (y - c) ** 2) / (2.0 * _SIGMA ** 2))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(cosine window, FFT of the target response, row and column grids)
    on ``device``."""
    hann = torch.from_numpy(_hann2d()).to(device)
    g = torch.fft.fft2(torch.from_numpy(_gauss_target()).to(device))
    yy, xx = torch.meshgrid(torch.arange(SIZE, device=device),
                            torch.arange(SIZE, device=device), indexing="ij")
    return hann, g, yy, xx


def _preprocess(patch: torch.Tensor) -> torch.Tensor:
    """log -> zero mean, unit variance -> cosine window, over the last two
    axes of ``patch`` [..., S, S]."""
    hann = _consts(patch.device)[0]
    p = torch.log1p(patch.to(torch.float32))
    mean = p.mean(dim=(-2, -1), keepdim=True)
    std = p.std(dim=(-2, -1), correction=0, keepdim=True)
    return (p - mean) / (std + 1e-5) * hann


def _init_filter(patches: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """patches [K, S, S] (augmented crops) -> (num, den) filter terms."""
    g = _consts(patches.device)[1]
    f = torch.fft.fft2(_preprocess(patches))
    return (g * torch.conj(f)).sum(0), (f * torch.conj(f)).sum(0)


def _respond_multi(num: torch.Tensor, den: torch.Tensor,
                   patches: torch.Tensor):
    """patches [K, S, S] -> per candidate (dy [K], dx [K], psr [K]): the
    response peak's displacement from the window centre and its
    peak-to-sidelobe ratio (the sidelobe is all outside an 11 x 11 window
    around the peak)."""
    _, _, yy, xx = _consts(patches.device)
    f = torch.fft.fft2(_preprocess(patches))
    resp = torch.fft.ifft2(num / (den + _REG) * f).real          # [K, S, S]
    flat = resp.reshape(resp.shape[0], -1)
    idx = torch.argmax(flat, dim=1)
    py, px = idx // SIZE, idx % SIZE
    peak = flat.gather(1, idx[:, None])[:, 0]
    side = ((yy - py[:, None, None]).abs() > 5) | \
        ((xx - px[:, None, None]).abs() > 5)
    n_side = side.sum(dim=(1, 2)).clamp(min=1)
    mu = (resp * side).sum(dim=(1, 2)) / n_side
    var = ((resp - mu[:, None, None]).square() * side).sum(dim=(1, 2)) \
        / n_side
    psr = (peak - mu) / torch.sqrt(var + 1e-9)
    dy = (py - SIZE // 2).to(torch.float32)
    dx = (px - SIZE // 2).to(torch.float32)
    return dy, dx, psr


def _respond(num: torch.Tensor, den: torch.Tensor, patch: torch.Tensor):
    """One patch [S, S] -> (dy, dx, psr, fft of the preprocessed
    patch)."""
    dy, dx, psr = _respond_multi(num, den, patch[None])
    return dy[0], dx[0], psr[0], torch.fft.fft2(_preprocess(patch))


def _update_filter(num, den, f, lr: float):
    g = _consts(f.device)[1]
    return ((1.0 - lr) * num + lr * g * torch.conj(f),
            (1.0 - lr) * den + lr * f * torch.conj(f))


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: rotate by ``angle`` degrees
    (counter-clockwise) and scale about ``center``; [2, 3] float64."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: torch.Tensor, m: np.ndarray, out_hw,
                border: str) -> torch.Tensor:
    """``cv2.warpAffine(img, m, (w, h), borderMode=...)`` of a float
    [H, W] image, bilinear: each output pixel samples the inverse of
    ``m`` (inverted as OpenCV does, in float64)."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a12, a21, a22 = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    hh, ww = out_hw
    y = torch.arange(hh, dtype=torch.float64, device=img.device)[:, None]
    x = torch.arange(ww, dtype=torch.float64, device=img.device)[None, :]
    return BilinearMap(a11 * x + a12 * y + b1, a21 * x + a22 * y + b2,
                       img.shape[:2], border)(img)


class MosseTracker:
    """The OpenCV tracker interface: ``init(img, (x, y, w, h))``, then
    ``ok, (x, y, w, h) = update(img)``. Images are numpy arrays or tensors
    (grey, or channels last), moved to the tracker's ``device``."""

    def __init__(self, lr: float = 0.125, psr_min: float = 5.0,
                 pad: float = 2.0, n_warps: int = 8, seed: int = 0,
                 search_scale: bool = True, scale_step: float = 1.035,
                 scale_damp: float = 0.6, search_rot: bool = False,
                 rot_step: float = 3.0, device="cuda"):
        self.lr = lr
        self.psr_min = psr_min
        self.pad = pad
        self.n_warps = n_warps
        self.seed = seed
        self.search_scale = search_scale
        self.scale_step = scale_step
        self.scale_damp = scale_damp
        self.search_rot = search_rot
        self.rot_step = rot_step
        self.device = resolve_device(device)
        self._angle = 0.0          # cumulative window rotation (degrees)
        self._num = None
        self._den = None

    def _gray(self, img) -> torch.Tensor:
        """The image as float32 grey [H, W] on the tracker's device: the
        mean of its first three channels."""
        if not torch.is_tensor(img):
            img = np.asarray(img)
            gray = (img.astype(np.float32) if img.ndim == 2 else
                    img[..., :3].astype(np.float32).mean(axis=-1))
            return torch.from_numpy(gray).to(self.device)
        img = img.to(self.device)
        if img.dim() == 2:
            return img.to(torch.float32)
        return img[..., :3].to(torch.float32).mean(dim=-1)

    def _crop(self, gray: torch.Tensor, scale: float = 1.0,
              angle: float = 0.0) -> torch.Tensor:
        """The window around the centre at ``scale`` (edge pixels repeat
        past the image), rotated by the window's angle plus ``angle``,
        resized to S x S."""
        if self._angle + angle != 0.0:
            m = rotation_matrix(self._center, self._angle + angle, 1.0)
            gray = warp_affine(gray, m, gray.shape, "replicate")
        cx, cy = self._center
        ww, wh = self._win[0] * scale, self._win[1] * scale
        x1, y1 = int(round(cx - ww / 2)), int(round(cy - wh / 2))
        h, w = gray.shape
        dev = gray.device
        rows = (torch.arange(int(wh), device=dev) + y1).clamp(0, h - 1)
        cols = (torch.arange(int(ww), device=dev) + x1).clamp(0, w - 1)
        patch = gray.index_select(0, rows).index_select(1, cols)
        return F.interpolate(patch[None, None], size=(SIZE, SIZE),
                             mode="bilinear", align_corners=False)[0, 0]

    def _augmented(self, base: torch.Tensor) -> torch.Tensor:
        """The base crop and ``n_warps - 1`` random rotations by up to 8
        degrees and scalings by up to 3 % about its centre (reflected at
        the border): [n_warps, S, S]."""
        rng = np.random.default_rng(self.seed)
        patches = [base]
        c = SIZE / 2.0
        for _ in range(self.n_warps - 1):
            ang = rng.uniform(-8.0, 8.0)
            scale = rng.uniform(0.97, 1.03)
            m = rotation_matrix((c, c), ang, scale)
            patches.append(warp_affine(base, m, (SIZE, SIZE), "reflect"))
        return torch.stack(patches)

    def init(self, img, bbox: Tuple[int, int, int, int]) -> None:
        x, y, w, h = [float(v) for v in bbox]
        self._size = (w, h)
        self._center = (x + w / 2.0, y + h / 2.0)
        self._win = (max(w * self.pad, 8.0), max(h * self.pad, 8.0))
        base = self._crop(self._gray(img))
        self._num, self._den = _init_filter(self._augmented(base))

    def update(self, img) -> Tuple[bool, Tuple[int, int, int, int]]:
        if self._num is None:
            raise RuntimeError("call init() first")
        gray = self._gray(img)

        scales = ((1.0 / self.scale_step, 1.0, self.scale_step)
                  if self.search_scale else (1.0,))
        angles = ((-self.rot_step, 0.0, self.rot_step)
                  if self.search_rot else (0.0,))
        cands = [(s, a) for a in angles for s in scales]
        patches = torch.stack([self._crop(gray, s, a) for s, a in cands])
        dys, dxs, psrs = torch.stack(_respond_multi(
            self._num, self._den, patches)).cpu().numpy()
        best = int(np.argmax(psrs))
        s_best, a_best = cands[best]
        psr = float(psrs[best])
        ok = psr >= self.psr_min
        if ok:
            # displacement in window units of the winning crop's scale
            sx = self._win[0] * s_best / SIZE
            sy = self._win[1] * s_best / SIZE
            # a rotated crop's displacement is in the rotated frame
            th = np.deg2rad(self._angle + a_best)
            dx, dy = float(dxs[best]), float(dys[best])
            dx_i = dx * np.cos(th) + dy * np.sin(th)
            dy_i = -dx * np.sin(th) + dy * np.cos(th)
            cx = self._center[0] + dx_i * sx
            cy = self._center[1] + dy_i * sy
            h, w = gray.shape
            self._center = (float(np.clip(cx, 0, w - 1)),
                            float(np.clip(cy, 0, h - 1)))
            if s_best != 1.0:                 # damped scale adaptation
                g = s_best ** self.scale_damp
                self._win = (max(self._win[0] * g, 8.0),
                             max(self._win[1] * g, 8.0))
                self._size = (self._size[0] * g, self._size[1] * g)
            if a_best != 0.0:                 # damped rotation adaptation
                self._angle += a_best * self.scale_damp
            # re-crop at the new centre so the filter trains on-target
            f = torch.fft.fft2(_preprocess(self._crop(gray)))
            self._num, self._den = _update_filter(self._num, self._den, f,
                                                  self.lr)
        bw, bh = self._size
        bbox = (int(round(self._center[0] - bw / 2)),
                int(round(self._center[1] - bh / 2)),
                int(round(bw)), int(round(bh)))
        return bool(ok), bbox

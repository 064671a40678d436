"""AFB-URR video segmentation network (counterpart of
``vfloodnet_tpu.models.afb_urr``), inference only.

A ResNet-50 memory encoder over (frame, mask, inverse mask), a ResNet-50
query encoder, a 3x3-conv key/value head (1024 -> 128 + 512), the memory
read against the feature bank (:func:`..ops.bank_attention_read`, the CUDA
kernels on the card), and a two-stage decoder with uncertainty-gated local
refinement.

The public methods keep the JAX package's layout: frames NHWC in [0, 1],
masks [obj_n, H, W], keys and values [n, P, d] with P = h16 * w16 in
row-major order, the bank [obj_n, N, d]. Inside, the convolutions run NCHW.
:meth:`AFBURR.memorize_streams` and :meth:`AFBURR.segment_streams` run B
independent streams as one batch, their banks folded along the object axis
([B x obj_n, N, d], stream-major): what the JAX package's batch engine gets
by vmapping ``memorize`` and ``segment`` over its streams.

``AFBURR(dtype=torch.bfloat16)`` computes in bf16 with the JAX package's
casts: the frame is normalised in float32 and cast at the encoders, the
mask at ``memorize``, the bank read's ``mem`` at ``decode_with_memory``;
the decoder's rough map is a float32 softmax cast back, the uncertainty is
float32, and the score is taken in float32. The query keys go to the read
as float32, and the read casts them to the bank's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (bank_attention_read, calc_uncertainty, local_avg_pool,
                   local_max_pool, pad_divide_by, unpad)
from .resnet import Conv2d, ResNet50Backbone

KEYDIM, VALDIM = 128, 512
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device):
    """(mean, std) [1, 3, 1, 1] float32 on ``device``, uploaded once: the
    step makes no host-to-device copy of its own."""
    return tuple(torch.tensor(v, dtype=torch.float32)[None, :, None, None]
                 .to(device) for v in (IMAGENET_MEAN, IMAGENET_STD))


def _normalize(frame: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation in float32."""
    mean, std = _imagenet_stats(frame.device)
    return (frame.float() - mean) / std


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, half-pixel centres (align_corners=False), computed in
    float32 and cast back to x's dtype."""
    return F.interpolate(x.float(), size=(2 * x.shape[-2], 2 * x.shape[-1]),
                         mode="bilinear", align_corners=False).to(x.dtype)


def _conv3(cin: int, cout: int, dtype: torch.dtype) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class ResBlock(nn.Module):
    """Pre-activation residual block (reference AFB_URR.py:10-30); the
    checkpoint's blocks all keep their width, so there is no downsample."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv3(channels, channels, dtype)
        self.conv2 = _conv3(channels, channels, dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Refine(nn.Module):
    """Skip refinement with 2x upsample (AFB_URR.py:114-127), split into
    the object-independent :meth:`skip` and the per-object :meth:`refine`."""

    def __init__(self, cin: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.convFS = _conv3(cin, channels, dtype)
        self.ResFS = ResBlock(channels, dtype)
        self.ResMM = ResBlock(channels, dtype)

    def skip(self, f):
        return self.ResFS(self.convFS(f))

    def refine(self, s, pm):
        return self.ResMM(s + _upsample2(pm))


class EncoderM(nn.Module):
    """Memory encoder over frame + mask + inverse mask (AFB_URR.py:33-63):
    one 5-plane stem, the reference's conv1(f) + conv1_m(m) + conv1_o(o)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet50Backbone(in_channels=5, dtype=dtype)

    def forward(self, frame, mask, mask_inv):
        """frame [n, 3, H, W] in [0, 1]; mask, mask_inv [n, 1, H, W]."""
        x = torch.cat([_normalize(frame).to(self.dtype),
                       mask.to(self.dtype), mask_inv.to(self.dtype)], dim=1)
        r4, _, _, r1 = self.backbone(x)
        return r4, r1


class EncoderQ(nn.Module):
    """Query encoder (AFB_URR.py:66-93)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet50Backbone(in_channels=3, dtype=dtype)

    def forward(self, frame):
        return self.backbone(_normalize(frame).to(self.dtype))


class KeyValue(nn.Module):
    """Key and value heads (AFB_URR.py:96-111) as one 1024 -> dk + dv
    conv. Returns key [n, P, dk] and value [n, P, dv]."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.conv = _conv3(1024, KEYDIM + VALDIM, dtype)

    def forward(self, x):
        n, _, h, w = x.shape
        out = self.conv(x).permute(0, 2, 3, 1).reshape(n, h * w, -1)
        return out[..., :KEYDIM], out[..., KEYDIM:]


class Decoder(nn.Module):
    """Global decode + uncertainty-gated local refinement
    (AFB_URR.py:181-239)."""

    def __init__(self, dtype: torch.dtype, mdim_global: int = 256,
                 mdim_local: int = 32, local_size: int = 7):
        super().__init__()
        self.dtype = dtype
        self.local_size = local_size
        self.convFM = _conv3(1024, mdim_global, dtype)
        self.ResMM = ResBlock(mdim_global, dtype)
        self.RF3 = Refine(512, mdim_global, dtype)
        self.RF2 = Refine(256, mdim_global, dtype)
        self.pred2 = _conv3(mdim_global, 2, dtype)
        self.local_convFM = _conv3(128, mdim_local, dtype)
        self.local_ResMM = ResBlock(mdim_local, dtype)
        self.local_pred2 = _conv3(mdim_local, 2, dtype)

    def forward(self, patch_match, r3, r2, r1, bs: int, obj_n: int):
        """patch_match [bs*obj_n, 1024, h16, w16]; skips r3, r2, r1 per
        batch [bs, C, h, w]. Returns per-object foreground log-odds
        [bs, obj_n, H, W]."""
        def per_obj(x):
            return x.repeat_interleave(obj_n, dim=0)

        p = self.ResMM(self.convFM(patch_match))
        p = self.RF3.refine(per_obj(self.RF3.skip(r3)), p)           # 1/8
        p = self.RF2.refine(per_obj(self.RF2.skip(r2)), p)           # 1/4
        r1 = per_obj(r1)
        p = _upsample2(self.pred2(F.relu(p)))                        # 1/2

        n, _, h, w = p.shape
        rough = torch.softmax(p.float(), dim=1)[:, 1].reshape(bs, obj_n, h, w)
        rough = torch.softmax(rough, dim=1)          # object-level norm
        unc = calc_uncertainty(rough, obj_axis=1)    # [bs, 1, h, w] float32
        unc = unc.repeat_interleave(obj_n, dim=0)
        rough = rough.reshape(n, 1, h, w).to(self.dtype)

        r1_local = local_avg_pool(r1 * rough, self.local_size)
        r1_local = r1_local / (local_avg_pool(rough, self.local_size) + 1e-8)
        r1_conf = local_max_pool(rough, self.local_size)
        q = self.local_ResMM(self.local_convFM(torch.cat([r1, r1_local], 1)))
        q = r1_conf * self.local_pred2(F.relu(q))

        p = _upsample2(p + unc.to(self.dtype) * q)                   # 1/1
        # per-object log-odds: logit1 - logit0 of the 2-class softmax
        p = p.float()
        score = p[:, 1] - p[:, 0]
        return score.reshape(bs, obj_n, 2 * h, 2 * w)


class AFBURR(nn.Module):
    """The full AFB-URR graph (see :meth:`memorize` and :meth:`segment`),
    computing in ``dtype`` (float32 or bfloat16)."""

    def __init__(self, thres_valid: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.thres_valid = thres_valid
        self.dtype = dtype
        self.encoder_m = EncoderM(dtype)
        self.encoder_q = EncoderQ(dtype)
        self.keyval_r4 = KeyValue(dtype)
        self.decoder = Decoder(dtype)

    def memorize(self, frame: torch.Tensor, mask: torch.Tensor):
        """frame [H, W, 3] in [0, 1], mask [obj_n, H, W] ->
        (k4 [obj_n, P, dk], v4 [obj_n, P, dv])."""
        return self.memorize_streams(frame[None], mask[None])

    def memorize_streams(self, frames: torch.Tensor, masks: torch.Tensor):
        """:meth:`memorize` of B streams as one batch: frames [B, H, W, 3]
        in [0, 1], masks [B, obj_n, H, W] -> (k4 [B x obj_n, P, dk], v4
        [B x obj_n, P, dv]), stream-major."""
        obj_n = masks.shape[1]
        frames, _ = pad_divide_by(frames, 16)
        masks, _ = pad_divide_by(masks.flatten(0, 1)[..., None], 16)
        frames = frames.permute(0, 3, 1, 2).repeat_interleave(obj_n, dim=0)
        masks = masks.permute(0, 3, 1, 2).to(self.dtype)
        r4, _ = self.encoder_m(frames, masks,
                               torch.clamp(1.0 - masks, 0.0, 1.0))
        return self.keyval_r4(r4)

    def encode_query(self, frames: torch.Tensor):
        """frames [B, H, W, 3] -> (k4 [B, P, dk], v4 [B, P, dv], skips
        (r3, r2, r1), (h16, w16), pad)."""
        frames, pad = pad_divide_by(frames, 16)
        r4, r3, r2, r1 = self.encoder_q(frames.permute(0, 3, 1, 2))
        k4, v4 = self.keyval_r4(r4)
        return k4, v4, (r3, r2, r1), tuple(r4.shape[-2:]), pad

    def decode_with_memory(self, mem: torch.Tensor, v4: torch.Tensor, skips,
                           hw16, pad) -> torch.Tensor:
        """mem [B, obj_n, P, dv] from the bank read -> score log-odds
        [B, obj_n, H, W] at the unpadded frame size."""
        r3, r2, r1 = skips
        h16, w16 = hw16
        bs, obj_n = mem.shape[:2]
        q_val = v4[:, None].expand(bs, obj_n, -1, -1)
        feat = torch.cat([mem.to(self.dtype), q_val], dim=-1)
        feat = feat.reshape(bs * obj_n, h16, w16, 2 * VALDIM)
        score = self.decoder(feat.permute(0, 3, 1, 2), r3, r2, r1, bs, obj_n)
        return unpad(score, pad, spatial_axes=(-2, -1))

    def segment(self, frames: torch.Tensor, bank_keys: torch.Tensor,
                bank_values: torch.Tensor, bank_valid: torch.Tensor,
                bank_occ: Optional[torch.Tensor] = None):
        """frames [B, H, W, 3]; bank [obj_n, N, d], bank_valid [obj_n, N];
        ``bank_occ`` [obj_n] int32 bounds the read at the occupancy ->
        (score log-odds [B, obj_n, H, W], usage counts [obj_n, N])."""
        k4, v4, skips, hw16, pad = self.encode_query(frames)
        occ_bound = None if bank_occ is None else bank_occ.max()
        mems, usage = [], None
        for b in range(k4.shape[0]):
            mem, cnt = bank_attention_read(bank_keys, bank_values, bank_valid,
                                           k4[b].float().contiguous(),
                                           thres=self.thres_valid,
                                           occ_bound=occ_bound)
            mems.append(mem)
            usage = cnt if usage is None else usage + cnt
        score = self.decode_with_memory(torch.stack(mems), v4, skips, hw16,
                                        pad)
        return score, usage

    def segment_streams(self, frames: torch.Tensor, bank_keys: torch.Tensor,
                        bank_values: torch.Tensor, bank_valid: torch.Tensor,
                        bank_occ: Optional[torch.Tensor] = None):
        """One frame of each of B independent streams: frames [B, H, W,
        3]; the B banks folded along the object axis, bank [B x obj_n, N,
        d] and bank_valid [B x obj_n, N]; ``bank_occ`` [B x obj_n] int32
        bounds the read at the largest occupancy of all of them. The B
        frames are encoded and decoded as one batch, and every stream's
        bank is read with its own frame's query in one read (one launch of
        each kernel on the card) -> (score log-odds [B, obj_n, H, W], usage
        counts [B x obj_n, N])."""
        k4, v4, skips, hw16, pad = self.encode_query(frames)
        occ_bound = None if bank_occ is None else bank_occ.max()
        mem, cnt = bank_attention_read(bank_keys, bank_values, bank_valid,
                                       k4.float().contiguous(),
                                       thres=self.thres_valid,
                                       occ_bound=occ_bound)
        bs = frames.shape[0]
        mem = mem.reshape((bs, -1) + mem.shape[1:])
        score = self.decode_with_memory(mem, v4, skips, hw16, pad)
        return score, cnt

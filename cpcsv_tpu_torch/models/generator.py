"""StoryGenerator of the PyTorch port.

Counterpart of `cpcsv_tpu/models/generator.py`, both variants behind the
`cascade` flag (reference `model.py:214-483`, `cascade_model.py:221-540`):

  content (B,T,356) --flatten--> CA-Net -> r_code / r_mu / r_logvar (124)
  motion  (B,T,365) --GRU + per-step noise--> zm (B*T,365)
                    --context GRU--> crnn_code (B*T,124)
  dynamic filter:  image_net(motion) (B*T,3,124) conv1d filter_net(crnn) (B*T,1,3,21)
  zmc = [zm | c_mu | dfn] (613) -> fc -> 4x4 map -> 4 UpBlocks -> 64x64 tanh image
  seg branch: a 1-channel trunk gating the image trunk at 4x4 and 8x8; the
  cascade variant re-encodes the generated mask and gates with its latents,
  and trains the re-encoder and the seg trunk as an autoencoder of masks
  (`train_autoencoder`).

Internally NCHW. The public samplers keep the JAX layouts: video
(B, T, 64, 64, 3), mask (N, 64, 64, 1), latents NHWC (as views).

Noise: each sampler takes `noise=(ca_eps, h0_noise, step_noise)`; when it is
None the three are drawn from `generator` in the JAX package's order: CA eps
(B, 124), then the motion GRU's h0 noise (B, 365), then the per-step noise
(B, T, 100).

The module's mode picks the BatchNorm statistics: eval mode serves with the
running ones; train mode normalises with the batch's and updates each BN's
running statistics in call order, and on the card the DFN's gradient comes
from its backward kernel (`ops/dynamic_filter.py`).

`dtype` is the compute dtype (cfg.COMPUTE_DTYPE; None = float32), threaded
as the JAX package threads it: the parameters stay float32, and CANet, the
dense heads, both GRUs, the DFN, both trunks and the cascade re-encoder run
in it, so the frames, masks, latents and CA codes come out in it. The noise
is drawn in float32, the inputs' dtype; the CA eps is cast to the CA codes'
dtype, as JAX draws it in that dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from cpcsv_tpu_torch.ops.blocks import (
    BatchNorm2d,
    Conv3x3,
    DenseBN,
    DownBlock,
    Linear,
    UpBlock,
)
from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d
from cpcsv_tpu_torch.ops.gru import gru_unroll

Noise = tuple  # (ca_eps (B, C), h0_noise (B, M), step_noise (B, T, Z))


class GeneratorOutput(NamedTuple):
    """The reference 7-tuple of sample_videos / sample_images."""

    latents: Optional[tuple]  # ((zmc_seg, h1, h2, h3), (g1, g2, g3, g4)) NHWC, or None
    image: torch.Tensor  # video (B, T, H, W, 3) or image (B, H, W, 3)
    m_mu: torch.Tensor
    m_logvar: torch.Tensor
    c_mu: torch.Tensor
    c_logvar: torch.Tensor
    seg: Optional[torch.Tensor]  # mask (N, H, W, 1) or None


class CANet(nn.Module):
    """Conditioning augmentation (reference `model.py:37-65`). The ReLU comes
    before the mu / logvar split."""

    def __init__(self, in_features: int, c_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c_dim = c_dim
        self.fc = Linear(in_features, c_dim * 2, dtype=dtype)

    def forward(self, text_embedding: torch.Tensor, eps: torch.Tensor):
        x = torch.relu(self.fc(text_embedding))
        mu, logvar = x[:, : self.c_dim], x[:, self.c_dim :]
        return mu + torch.exp(0.5 * logvar) * eps.to(mu.dtype), mu, logvar


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class StoryGenerator(nn.Module):
    def __init__(
        self,
        video_len: int = 5,
        n_channels: int = 3,
        motion_dim: int = 365,
        content_dim: int = 124,
        noise_dim: int = 100,
        gf_dim: int = 2048,
        gf_dim_seg: int = 1024,
        text_dim: int = 356,
        use_segment: bool = True,
        cascade: bool = False,
        filter_num: int = 3,
        filter_size: int = 21,
        image_size: int = 124,
        out_num: int = 1,
        torch_repeat_quirk: bool = False,
        fused_upsample: str = "off",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.video_len = video_len
        self.motion_dim, self.content_dim = motion_dim, content_dim
        self.noise_dim, self.text_dim = noise_dim, text_dim
        self.gf_dim, self.gf_dim_seg = gf_dim, gf_dim_seg
        self.use_segment, self.cascade = use_segment, cascade
        self.filter_num, self.filter_size = filter_num, filter_size
        self.image_size, self.out_num = image_size, out_num
        self.torch_repeat_quirk = torch_repeat_quirk
        self.dtype = dt = dtype
        ngf, ngf_seg, fu = gf_dim, gf_dim_seg, fused_upsample
        ninput = motion_dim + content_dim + image_size  # 613

        self.ca_net = CANet(text_dim * video_len, content_dim, dt)
        self.filter_net = DenseBN(content_dim, filter_size * filter_num * out_num, dtype=dt)
        self.image_net = DenseBN(motion_dim, image_size * filter_num, nn.Tanh(), dtype=dt)
        self.fc = DenseBN(ninput, ngf * 16, nn.ReLU(), bias=False, dtype=dt)
        self.upsample1 = UpBlock(ngf, ngf // 2, fu, dt)
        self.upsample2 = UpBlock(ngf // 2, ngf // 4, fu, dt)
        self.upsample3 = UpBlock(ngf // 4, ngf // 8, fu, dt)
        self.upsample4 = UpBlock(ngf // 8, ngf // 16, fu, dt)
        self.img = nn.Sequential(Conv3x3(ngf // 16, n_channels, dt), nn.Tanh())

        if use_segment:
            self.seg_c = Conv3x3(ngf_seg, ngf, dt)
            self.seg_c1 = Conv3x3(ngf_seg // 2, ngf // 2, dt)
            self.fc_seg = DenseBN(ninput, ngf_seg * 16, nn.ReLU(), bias=False, dtype=dt)
            self.upsample1_seg = UpBlock(ngf_seg, ngf_seg // 2, fu, dt)
            self.upsample2_seg = UpBlock(ngf_seg // 2, ngf_seg // 4, fu, dt)
            self.upsample3_seg = UpBlock(ngf_seg // 4, ngf_seg // 8, fu, dt)
            self.upsample4_seg = UpBlock(ngf_seg // 8, ngf_seg // 16, fu, dt)
            self.img_seg = nn.Sequential(Conv3x3(ngf_seg // 16, 1, dt), nn.Tanh())
            if cascade:
                # mask re-encoder (reference cascade_model.py:312-320)
                self.presample = nn.Sequential(
                    Conv3x3(1, ngf_seg // 16, dt), BatchNorm2d(ngf_seg // 16), nn.ReLU()
                )
                self.downsample1_seg = DownBlock(ngf_seg // 16, ngf_seg // 8, dt)
                self.downsample2_seg = DownBlock(ngf_seg // 8, ngf_seg // 4, dt)
                self.downsample3_seg = DownBlock(ngf_seg // 4, ngf_seg // 2, dt)
                self.downsample4_seg = DownBlock(ngf_seg // 2, ngf_seg, dt)

        self.m_net = DenseBN(motion_dim, motion_dim, dtype=dt)
        self.c_net = DenseBN(content_dim, content_dim, dtype=dt)
        self.recurrent = nn.GRUCell(noise_dim + motion_dim, motion_dim)
        self.mocornn = nn.GRUCell(motion_dim, content_dim)

    # ------------------------------------------------------------------ noise
    def draw_noise(
        self, batch: int, steps: int, generator: torch.Generator | None = None
    ) -> Noise:
        """(ca_eps, h0_noise, step_noise) in the JAX package's draw order."""
        dev = self.fc[0].weight.device
        shapes = ((batch, self.content_dim), (batch, self.motion_dim),
                  (batch, steps, self.noise_dim))
        return tuple(torch.randn(s, generator=generator, device=dev) for s in shapes)

    # ------------------------------------------------------------------- RNNs
    def sample_z_motion(self, m_code, h0_noise, step_noise) -> torch.Tensor:
        """Motion GRU with fresh noise per step (reference `model.py:321-334`).
        m_code (B, T, 365) or (B, 365) -> (B*T, 365), b-major."""
        steps = step_noise.shape[1]
        if m_code.dim() == 2:
            m_code = m_code[:, None, :].expand(-1, steps, -1)
        xs = torch.cat([step_noise, m_code[:, :steps]], dim=-1)
        hs = gru_unroll(self.recurrent, self.m_net(h0_noise), xs, self.dtype)
        return hs.reshape(-1, self.motion_dim)

    def motion_content_rnn(self, motion_input, content_code) -> torch.Tensor:
        """Context GRU (reference `model.py:336-346`)."""
        if motion_input.dim() == 2:
            motion_input = motion_input[:, None, :]
        hs = gru_unroll(self.mocornn, self.c_net(content_code), motion_input, self.dtype)
        return hs.reshape(-1, self.content_dim)

    # ------------------------------------------------------------- DFN fusion
    def _dfn_fuse(self, m_code_flat, crnn_code) -> torch.Tensor:
        m_image = self.image_net(m_code_flat).reshape(-1, self.filter_num, self.image_size)
        c_filter = self.filter_net(crnn_code).reshape(
            -1, self.out_num, self.filter_num, self.filter_size
        )
        mc = dynamic_filter_conv1d(m_image, c_filter, pad=self.filter_size // 2)
        return mc.reshape(-1, self.image_size)

    # ----------------------------------------------------------------- decode
    def _reencode_mask(self, mask):
        z = self.presample(mask)
        g4 = self.downsample1_seg(z)  # 32x32
        g3 = self.downsample2_seg(g4)  # 16x16
        g2 = self.downsample3_seg(g3)  # 8x8
        g1 = self.downsample4_seg(g2)  # 4x4
        return g1, g2, g3, g4

    def _decode(self, zmc_all):
        """Shared trunk. Returns (frames (N,3,64,64), latents, mask (N,1,64,64));
        the dense heads are channel-major, so a view gives the 4x4 map."""
        zmc_img = self.fc(zmc_all).view(-1, self.gf_dim, 4, 4)
        if not self.use_segment:
            h = self.upsample4(self.upsample3(self.upsample2(self.upsample1(zmc_img))))
            return self.img(h), None, None

        zmc_seg = self.fc_seg(zmc_all).view(-1, self.gf_dim_seg, 4, 4)
        if self.cascade:
            # seg trunk first, re-encode the mask, then gate the image trunk
            h_seg1 = self.upsample1_seg(zmc_seg)
            h_seg2 = self.upsample2_seg(h_seg1)
            h_seg3 = self.upsample3_seg(h_seg2)
            mask = self.img_seg(self.upsample4_seg(h_seg3))
            g1, g2, g3, g4 = self._reencode_mask(mask)
            zmc_img = self.seg_c(g1) * zmc_img + zmc_img
            h_img = self.upsample1(zmc_img)
            h_img = self.seg_c1(g2) * h_img + h_img
            h_img = self.upsample4(self.upsample3(self.upsample2(h_img)))
            latents = ((zmc_seg, h_seg1, h_seg2, h_seg3), (g1, g2, g3, g4))
            return self.img(h_img), latents, mask
        # v1: the seg trunk gates the image trunk directly (model.py:381-407)
        zmc_img = self.seg_c(zmc_seg) * zmc_img + zmc_img
        h_seg = self.upsample1_seg(zmc_seg)
        h_img = self.upsample1(zmc_img)
        h_img = self.seg_c1(h_seg) * h_img + h_img
        h_seg = self.upsample2_seg(h_seg)
        h_img = self.upsample2(h_img)
        h_seg = self.upsample3_seg(h_seg)
        h_img = self.upsample3(h_img)
        h_seg = self.upsample4_seg(h_seg)
        h_img = self.upsample4(h_img)
        return self.img(h_img), None, self.img_seg(h_seg)

    @staticmethod
    def _public_latents(latents):
        if latents is None:
            return None
        return tuple(tuple(_nhwc(t) for t in group) for group in latents)

    # ------------------------------------------------------------- public API
    def sample_videos(
        self,
        motion_input: torch.Tensor,  # (B, T, 365)
        content_input: torch.Tensor,  # (B, T, 356)
        seg: bool = False,
        noise: Noise | None = None,
        generator: torch.Generator | None = None,
    ) -> GeneratorOutput:
        B, T = motion_input.shape[0], motion_input.shape[1]
        if T != self.video_len or content_input.shape[-1] != self.text_dim:
            raise ValueError(
                f"sample_videos got T={T}, text={content_input.shape[-1]} but the "
                f"generator was built with video_len={self.video_len}, "
                f"text_dim={self.text_dim} (cfg.VIDEO_LEN / cfg.TEXT.DIMENSION)"
            )
        ca_eps, h0_noise, step_noise = noise or self.draw_noise(B, T, generator)
        r_code, r_mu, r_logvar = self.ca_net(content_input.reshape(B, -1), ca_eps)
        if self.torch_repeat_quirk:
            c_mu = r_mu.repeat(T, 1)  # reference model.py:361 mispairing
        else:
            c_mu = r_mu.repeat_interleave(T, dim=0)  # (B*T, 124), frame-major

        crnn_code = self.motion_content_rnn(motion_input, r_code)
        m_flat = motion_input.reshape(-1, self.motion_dim)
        zm_code = self.sample_z_motion(motion_input, h0_noise, step_noise)
        mc_image = self._dfn_fuse(m_flat, crnn_code)
        zmc_all = torch.cat([zm_code, c_mu, mc_image], dim=1)  # (B*T, 613)

        frames, latents, mask = self._decode(zmc_all)
        video = _nhwc(frames).reshape(B, T, *frames.shape[2:], frames.shape[1])
        return GeneratorOutput(
            latents=self._public_latents(latents),
            image=video,
            m_mu=m_flat,
            m_logvar=m_flat,
            c_mu=r_mu,
            c_logvar=r_logvar,
            seg=_nhwc(mask) if seg and mask is not None else None,
        )

    def train_autoencoder(self, real_segments: torch.Tensor) -> torch.Tensor:
        """Seg autoencoder reconstruction (reference cascade_model.py:528-540):
        mask (N, 64, 64, 1) -> re-encoder -> the seg trunk's upsample1_seg ..
        upsample4_seg and img_seg -> (N, 64, 64, 1). It runs the same modules
        as the seg trunk, so in train mode each call updates their BN running
        statistics too."""
        if not self.cascade:
            raise ValueError("the seg autoencoder exists only in the cascade generator")
        g1, _, _, _ = self._reencode_mask(real_segments.permute(0, 3, 1, 2))
        h = self.upsample4_seg(self.upsample3_seg(self.upsample2_seg(self.upsample1_seg(g1))))
        return _nhwc(self.img_seg(h))

    def sample_images(
        self,
        motion_input: torch.Tensor,  # (B, 365)
        content_input: torch.Tensor,  # (B, T, 356)
        seg: bool = False,
        noise: Noise | None = None,
        generator: torch.Generator | None = None,
    ) -> GeneratorOutput:
        B = motion_input.shape[0]
        ca_eps, h0_noise, step_noise = noise or self.draw_noise(B, 1, generator)
        _, c_mu, c_logvar = self.ca_net(content_input.reshape(B, -1), ca_eps)

        crnn_code = self.motion_content_rnn(motion_input, c_mu)
        zm_code = self.sample_z_motion(motion_input, h0_noise, step_noise)  # (B, 365)
        mc_image = self._dfn_fuse(motion_input, crnn_code)
        zmc_all = torch.cat([zm_code, c_mu, mc_image], dim=1)

        frames, latents, mask = self._decode(zmc_all)
        return GeneratorOutput(
            latents=self._public_latents(latents),
            image=_nhwc(frames),  # (B, 64, 64, 3)
            m_mu=motion_input,
            m_logvar=motion_input,
            c_mu=c_mu,
            c_logvar=c_logvar,
            seg=_nhwc(mask) if seg and mask is not None else None,
        )

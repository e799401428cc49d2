"""Streaming sliding-window inference with the recurrent L1-feature cache
(counterpart of ``cdfo_tpu/infer/pipeline.py``).

Reproduces the reference eval semantics (`test_LD_37.py:115-206`):
  * clamped 7-frame window per output frame;
  * priors indexed max(1, i) (frame 0 is an I-frame with no inter priors);
  * the center frame's MV field expanded to 7 flows (`mv2mvs`) with
    edge-frame fixups;
  * frame 0 runs the full-window embed; every later frame reuses 6/7 of the
    cached features and embeds only the newest frame (`SIDECVSR_our.py:
    4416-4427`);
  * 270-row inputs padded to 272 with two zero rows (`test_LD_37.py:24-26`),
    1088/736-row outputs cropped back to 1080/720 (`:172-177`).

Window building is host-side numpy, staged onto the device in chunks
outside the timed region, matching the reference's FPS timing boundary
(`test_LD_22_FPS.py:183-189`). Also here: the sequence container and the
seeded synthetic sequence the tests, the tools and ``chip_smoke.py`` run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ops.mv import generate_input_index, modify_mv_for_end_frames, mv2mvs


def pad_lr_frame(img: np.ndarray) -> np.ndarray:
    """(H, W) [0,1] float; 270-row frames get two zero rows appended."""
    if img.shape[0] == 270:
        img = np.concatenate([img, np.zeros((2, img.shape[1]), img.dtype)], axis=0)
    return img


def crop_sr_output(sr: np.ndarray) -> np.ndarray:
    """(H, W) SR output; undo the LR padding at 4x scale."""
    if sr.shape[0] == 1088:
        return sr[:-8]
    if sr.shape[0] == 736:
        return sr[:-16]
    return sr


@dataclasses.dataclass
class SequenceData:
    """Host-side arrays for one sequence.

    lr, pm, rm, uf: (T, H, W) float32 in [0,1] (lr/pm already padded to a
    multiple of 8 rows; uf comes at 272 rows natively in the CVCP layout).
    mvl0, mvl1: (T, H_mv, W_mv, 3) raw decoder fields ([dy, dx, refoff]).
    """

    lr: np.ndarray
    pm: np.ndarray
    rm: np.ndarray
    uf: np.ndarray
    mvl0: np.ndarray
    mvl1: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.lr.shape[0]


class StreamingInferencer:
    """The per-window loop: one ``forward`` per output frame, the first
    on the full window, every later one with the previous window's L1
    features as ``pre_l1``, for the models whose forward takes (lrs, mvs0,
    mvs1, pms, rms, ufs): the CVSR_V8 family, CVSR_V9 and CVSR_V7. Runs on
    the device of ``model``'s parameters. Under ``mask_mode="sample"`` the
    EGLA mask's gumbel noise is drawn per window from ``generator`` (on
    that device; seeded with 0 if not given), which every ``run_sequence``
    restarts from the state it had here, as the JAX loop restarts from its
    ``mask_rng``."""

    def __init__(self, model, nframes: int = 7,
                 generator: Optional[torch.Generator] = None):
        if not getattr(model, "takes_mv_pair", False):
            raise ValueError(
                "StreamingInferencer drives forward(lrs, mvs0, mvs1, pms, "
                f"rms, ufs); {type(model).__name__} does not take that "
                "signature: call its forward directly")
        self.model = model
        self.nframes = nframes
        self.device = next(model.parameters()).device
        self.generator = None
        if model.cfg.mask_mode == "sample":
            self.generator = generator or torch.Generator(
                device=self.device).manual_seed(0)
            self._generator_state = self.generator.get_state()

    def _build_window(self, data: SequenceData, i: int):
        n = self.nframes
        t = data.num_frames
        o_list = generate_input_index(i, n, t - 1)
        prior_idx = np.maximum(o_list, 1)
        lrs = data.lr[o_list][None, ..., None]
        pms = data.pm[prior_idx][None, ..., None]
        rms = data.rm[prior_idx][None, ..., None]
        ufs = data.uf[prior_idx][None, ..., None]

        ci = max(1, i)
        h, w = data.lr.shape[1:]
        mvs0 = mv2mvs(data.mvl0[ci], n)
        mvs1 = mv2mvs(data.mvl1[ci], n)
        modify_mv_for_end_frames(i, mvs0, t)
        modify_mv_for_end_frames(i, mvs1, t)
        if mvs0.shape[1] != h:  # MV fields are exported at 270 rows
            pad = h - mvs0.shape[1]
            mvs0 = np.pad(mvs0, ((0, 0), (0, pad), (0, 0), (0, 0)))
            mvs1 = np.pad(mvs1, ((0, 0), (0, pad), (0, 0), (0, 0)))
        return (lrs.astype(np.float32), mvs0[None], mvs1[None],
                pms.astype(np.float32), rms.astype(np.float32),
                ufs.astype(np.float32))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run_sequence(self, data: SequenceData, collect_timing: bool = False):
        """Returns (sr_frames uint8 (T, H_out, W_out), fps or None).

        fps uses the reference's boundary (`test_LD_22_FPS.py:183-189`):
        only the forward is timed, each closed by a synchronize; window
        prep and input staging happen before the timer, the uint8
        conversion and readback after it. Frame 0's forward (the full
        window) is left out: fps = (T - 1) / the other forwards' time.
        """
        if self.generator is not None:
            self.generator.set_state(self._generator_state)
        t = data.num_frames
        # chunked staging: windows are prepared and uploaded in bursts of
        # ``chunk`` frames (device memory stays O(chunk): JCT-VC sequences
        # run to 600 frames), each burst outside the timed region
        chunk = 16
        l1 = None
        out_frames = [None] * t
        total_fwd = 0.0
        for c0 in range(0, t, chunk):
            c1 = min(c0 + chunk, t)
            windows = [tuple(torch.from_numpy(np.ascontiguousarray(a))
                             .to(self.device)
                             for a in self._build_window(data, i))
                       for i in range(c0, c1)]
            self._sync()
            srs = []
            for i in range(c0, c1):
                t0 = time.perf_counter()
                sr, l1 = self.model(*windows[i - c0], pre_l1=l1,
                                    generator=self.generator)
                if collect_timing:
                    self._sync()
                    if i > 0:  # the first frame runs the full window
                        total_fwd += time.perf_counter() - t0
                srs.append(sr)
            for i, sr in zip(range(c0, c1), srs):
                # truncating quantisation, as the reference's
                # clip(0, 1) * 255 then astype(uint8)
                sr8 = (sr[0, :, :, 0].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
                out_frames[i] = crop_sr_output(sr8.cpu().numpy())
        fps = None
        if collect_timing and t > 1:
            fps = (t - 1) / total_fwd
        return np.stack(out_frames), fps


def synthetic_sequence(t: int = 12, h: int = 64, w: int = 96,
                       seed: int = 0) -> SequenceData:
    """Small random sequence for tests and smoke runs; the same seed gives
    the same arrays as ``cdfo_tpu.infer.pipeline.synthetic_sequence``."""
    r = np.random.RandomState(seed)
    lr = r.rand(t, h, w).astype(np.float32)
    pm = (r.rand(t, h, w) > 0.5).astype(np.float32)
    rm = (r.rand(t, h, w).astype(np.float32) - 0.5) * 0.2
    uf = np.clip(lr + r.randn(t, h, w).astype(np.float32) * 0.02, 0, 1)
    # MV maps are piecewise constant over 4x4 pixel blocks, like the real
    # coding priors (HEVC motion vectors live on >=4x4 luma partitions)
    hb, wb = -(-h // 4), -(-w // 4)
    mv = np.zeros((t, h, w, 3), np.float32)
    for ax in (0, 1):
        blk = r.randint(-16, 16, (t, hb, wb)).astype(np.float32)
        mv[..., ax] = np.repeat(np.repeat(blk, 4, axis=1), 4,
                                axis=2)[:, :h, :w]
    mv[..., 2] = -1
    return SequenceData(lr, pm, rm, uf, mv, mv.copy())

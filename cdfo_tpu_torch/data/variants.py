"""Dataset variants beyond the CVCP side-info set (a numpy copy of
``cdfo_tpu/data/variants.py``, whose package imports JAX; the tests hold
the two equal; reference `opt/`):

* LR-only pairs (``data_LD_LR.py`` ``CDVL_Dataset`` + 13-frame ``_ETC``)
* REDS / Vimeo90K compressed-frame trees (``data_LD_REDS.py``,
  ``data_LD_Vimeo.py``: no coding priors)
* single-MV mode (``data_LD.py:195-210``: mvl1 := mvl0)

All yield the same NHWC batch dict as :class:`TrainBatcher` (prior slots
zero-filled when the source has none) so every model variant trains off one
interface.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .io import read_gray, write_gray


class FramePairDataset:
    """Generic LR/HR frame-tree dataset without coding priors.

    layout='flat':   <root>/<lr_dirname>/<seq>/%05d.png (REDS-style)
    layout='vimeo':  <root>/<lr_dirname>/<clip>/<subclip>/im%d.png
    """

    def __init__(self, lr_root: str, hr_root: str, seq_names: Sequence[str],
                 frames_per_seq: int, layout: str = "flat",
                 file_pattern: Optional[str] = None,
                 first_index: Optional[int] = None):
        if layout == "vimeo":
            # Vimeo90K grammar (`opt/data_LD_Vimeo.py:10-40`): frames are
            # im1.png..im7.png under <clip>/<subclip>; seq entries may be
            # clips (expanded to every subclip) or 'clip/subclip' paths
            file_pattern = file_pattern or "im%d.png"
            first_index = 1 if first_index is None else first_index
            expanded = []
            for seq in seq_names:
                d = os.path.join(lr_root, seq)
                subs = sorted(s for s in os.listdir(d)
                              if os.path.isdir(os.path.join(d, s)))
                if subs:
                    expanded.extend(f"{seq}/{s}" for s in subs)
                else:
                    expanded.append(seq)
            seq_names = expanded
        else:
            file_pattern = file_pattern or "%05d.png"
            first_index = 0 if first_index is None else first_index
        self.seqs = list(seq_names)
        self.fps = frames_per_seq
        lr_list, hr_list = [], []
        for seq in self.seqs:
            lrs, hrs = [], []
            for i in range(frames_per_seq):
                name = file_pattern % (i + first_index)
                lrs.append(read_gray(os.path.join(lr_root, seq, name)))
                hrs.append(read_gray(os.path.join(hr_root, seq, name)))
            lr_list.append(np.stack(lrs))
            hr_list.append(np.stack(hrs))
        self.lr = np.stack(lr_list)   # (S, T, h, w) uint8
        self.hr = np.stack(hr_list)   # (S, T, 4h, 4w) uint8

    def __len__(self):
        return len(self.seqs)


class LRBatcher:
    """Batches for prior-free training (priors zero, MVs zero), supporting
    the 7-frame default and the 13-frame ETC window
    (`opt/data_LD_LR.py:129`)."""

    def __init__(self, ds: FramePairDataset, batch_size: int, crop: int = 64,
                 nframes: int = 7, seed: int = 4, augment: bool = True,
                 all_gt: bool = False):
        self.ds = ds
        self.b = batch_size
        self.crop = crop
        self.n = nframes
        self.rng = np.random.RandomState(seed)
        self.augment = augment
        self.all_gt = all_gt  # ETC variants supervise every frame

    def sample_batch(self) -> dict:
        ds, r, cr, n = self.ds, self.rng, self.crop, self.n
        s_n, s_t, h, w = ds.lr.shape
        lrs = np.empty((self.b, n, cr, cr, 1), np.float32)
        hr_frames = n if self.all_gt else 1
        hrs = np.empty((self.b, hr_frames, 4 * cr, 4 * cr, 1), np.float32)
        for k in range(self.b):
            s = r.randint(0, s_n)
            start = r.randint(0, s_t - n + 1) if s_t > n else 0
            top = r.randint(0, h - cr) if h > cr else 0
            left = r.randint(0, w - cr) if w > cr else 0
            lr = ds.lr[s, start:start + n, top:top + cr,
                       left:left + cr].astype(np.float32) / 255.0
            if self.all_gt:
                hr = ds.hr[s, start:start + n, top * 4:(top + cr) * 4,
                           left * 4:(left + cr) * 4].astype(np.float32) / 255.0
            else:
                hr = ds.hr[s, start + n // 2, top * 4:(top + cr) * 4,
                           left * 4:(left + cr) * 4].astype(np.float32) / 255.0
                hr = hr[None]
            if self.augment:
                hf, vf, rot = (r.rand() < 0.5, r.rand() < 0.5, r.rand() < 0.5)

                def geo(x):
                    if hf:
                        x = x[..., ::-1]
                    if vf:
                        x = x[..., ::-1, :]
                    if rot:
                        x = np.swapaxes(x, -2, -1)
                    return np.ascontiguousarray(x)

                lr, hr = geo(lr), geo(hr)
            lrs[k, ..., 0] = lr
            hrs[k, ..., 0] = hr
        zeros = np.zeros_like(lrs)
        mv = np.zeros((self.b, n, cr, cr, 2), np.float32)
        return {"lrs": lrs, "mvs0": mv, "mvs1": mv.copy(), "pms": zeros,
                "rms": zeros.copy(), "ufs": zeros.copy(),
                "hr": hrs[:, 0] if not self.all_gt else hrs}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample_batch()


def single_mv_batch(batch: dict) -> dict:
    """Older single-MV datasets set mvl1 := mvl0 (`opt/data_LD.py:195-210`)."""
    out = dict(batch)
    out["mvs1"] = batch["mvs0"].copy()
    return out


def make_synthetic_frame_tree(root: str, num_seqs: int = 2, frames: int = 8,
                              h: int = 32, w: int = 48, seed: int = 0,
                              lr_dirname: str = "lr", hr_dirname: str = "hr"
                              ) -> List[str]:
    """A flat LR/HR frame tree of seeded noise (``<root>/<lr_dirname>/<seq>/
    %05d.png`` and the x4 HR beside it); returns the sequence names."""
    r = np.random.RandomState(seed)
    names = []
    for s in range(num_seqs):
        seq = f"{s:03d}"
        names.append(seq)
        for i in range(frames):
            write_gray(os.path.join(root, lr_dirname, seq, "%05d.png" % i),
                       r.randint(0, 255, (h, w), dtype=np.uint8))
            write_gray(os.path.join(root, hr_dirname, seq, "%05d.png" % i),
                       r.randint(0, 255, (h * 4, w * 4), dtype=np.uint8))
    return names

"""Training dataset + batcher for the CVCP coding-prior layout (a copy of
``cdfo_tpu/data/dataset.py``, which imports JAX through its package; the
tests hold the two equal). The native C++ batcher is ``data/native.py``:
the trainer draws LD batches from it and RA batches from ``TrainBatcher``.

Reimplements the reference pipeline (`opt/data_LD_bi.py`):

* the RAM preload of uint8/int8 arrays (`:55-134`) becomes an on-disk cache
  directory of per-array .npy files, built STREAMING (one sequence in RAM
  at a time) and loaded as true memmaps — same numerics (incl. the int8 MV
  clip `:91`); the real 579-sequence ~50 GB set never has to fit in RAM;
* the per-sample transform chain RandomCrop(64) -> Augment -> ToTensor
  (`train_LD_37.py:303`) becomes a vectorised numpy batcher producing
  NHWC model-ready batches (crop, flip/rot with MV sign fixups, center-MV
  expansion, /255 and /4/32 scalings);
* worker processes are replaced by a prefetch thread; per-host sharding
  (`DistSampler` analog) = stride slicing over the sequence list.

Note the reference LD-training quirk: only mvl0 is expanded into flows;
mvl1 flows are all zero (`opt/data_LD_bi.py:473-489`) although the model
consumes mvs1 (`SIDECVSR_our.py:4445`). ``zero_mvl1`` preserves this;
set False to feed real L1 flows (the RA path and our recommended fix).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..config import DataConfig
from ..ops.mv import augment_mv
from .io import read_gray


class CVCPDataset:
    """Preloaded training arrays for one coding config + QP."""

    def __init__(self, root: str, cfg: DataConfig, seq_names=None,
                 cache_path: Optional[str] = None,
                 host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        c, qp, t = cfg.coding_cfg, cfg.qp, cfg.frames_per_seq
        if seq_names is None:
            import csv as _csv
            with open(os.path.join(root, "sequences_list.csv")) as f:
                rows = list(_csv.reader(f))
            seq_names = [r[0] for r in rows[1:] if r]
        # per-host shard of the sequence list (DistSampler analog)
        seq_names = seq_names[host_id::num_hosts]
        self.seq_names = seq_names

        arrays = ("lr", "hr", "pm", "rm", "uf", "mv0", "mv1", "qp")
        if cache_path and os.path.isdir(cache_path) and os.path.exists(
                os.path.join(cache_path, "DONE")):
            # per-array .npy memmaps: TRUE mmap_mode (npz members decompress
            # into RAM on access — the round-1 cache's mmap claim was wrong)
            for name in arrays:
                setattr(self, name, np.load(
                    os.path.join(cache_path, name + ".npy"), mmap_mode="r"))
            return

        def load_seq(seq):
            lr_dir = os.path.join(root, "Decoded_LR", c, f"QP{qp}",
                                  f"{c}_{seq}_32F_QP{qp}.yuv")
            hr_dir = os.path.join(root, "Uncompressed_HR", seq)
            pri = os.path.join(root, "Coding_Priors", c, f"QP{qp}",
                               f"{c}_{seq}_32F_QP{qp}.priors")
            unf = os.path.join(root, f"pred_unfiltered_{c}", f"QP{qp}",
                               f"{c}_{seq}_32F_QP{qp}.priors",
                               "pred_unfiltered")
            lrs, hrs, pms, rms, ufs, mv0s, mv1s = ([], [], [], [], [], [], [])
            for f_i in range(t):
                idx = "%05d" % f_i
                lrs.append(read_gray(os.path.join(lr_dir, idx + ".png")))
                hrs.append(read_gray(os.path.join(hr_dir, idx + ".png")))
                pms.append(read_gray(os.path.join(
                    pri, "Partition_Map", idx + "_M_mask.png")))
                res = np.load(os.path.join(pri, "Residue", idx + "_res.npy"))
                if res.ndim == 3:
                    res = res[:, :, 0]
                rms.append(np.clip(res, -128, 127).astype(np.int8))
                ufs.append(read_gray(os.path.join(unf, idx + "_unflt.png")))
                mv0s.append(np.clip(
                    np.load(os.path.join(pri, "MV_l0", idx + "_mvl0.npy")),
                    -128, 127).astype(np.int8))
                mv1s.append(np.clip(
                    np.load(os.path.join(pri, "MV_l1", idx + "_mvl1.npy")),
                    -128, 127).astype(np.int8))
            # per-sequence QP vector: the reference allocates a per-frame QP
            # buffer and ToTensor scales it /52 (`opt/data_LD_bi.py:61,350`);
            # its loader line is commented out, so missing files mean zeros
            qp_file = os.path.join(pri, f"{c}_{seq}_4_QP_v.npy")
            if os.path.exists(qp_file):
                qpv = np.asarray(np.load(qp_file)).reshape(-1)[:t]
                qpv = np.pad(qpv, (0, t - qpv.size)).astype(np.int8)
            else:
                qpv = np.zeros(t, np.int8)
            return (np.stack(lrs), np.stack(hrs), np.stack(pms),
                    np.stack(rms), np.stack(ufs), np.stack(mv0s),
                    np.stack(mv1s), qpv)

        n_seq = len(seq_names)
        first = load_seq(seq_names[0])
        if cache_path:
            # streaming build: allocate on-disk memmaps from sequence 0's
            # shapes and fill one sequence at a time (never holds more than
            # one sequence in RAM — the real CVCP set is ~50 GB)
            os.makedirs(cache_path, exist_ok=True)
            mms = []
            for name, a in zip(arrays, first):
                mm = np.lib.format.open_memmap(
                    os.path.join(cache_path, name + ".npy"), mode="w+",
                    dtype=a.dtype, shape=(n_seq,) + a.shape)
                mm[0] = a
                mms.append(mm)
            for si in range(1, n_seq):
                for mm, a in zip(mms, load_seq(seq_names[si])):
                    mm[si] = a
            for mm in mms:
                mm.flush()
            with open(os.path.join(cache_path, "DONE"), "w") as f:
                f.write("ok")
            del mms
            for name in arrays:
                setattr(self, name, np.load(
                    os.path.join(cache_path, name + ".npy"), mmap_mode="r"))
            return

        # no cache: hold in RAM (tests / small subsets)
        stacks = [[a] for a in first]
        for si in range(1, n_seq):
            for lst, a in zip(stacks, load_seq(seq_names[si])):
                lst.append(a)
        (self.lr, self.hr, self.pm, self.rm, self.uf, self.mv0, self.mv1,
         self.qp) = [np.stack(lst) for lst in stacks]

    def __len__(self):
        return self.lr.shape[0]


class TrainBatcher:
    """Yields model-ready NHWC batches with the reference's sampling and
    augmentation semantics."""

    def __init__(self, ds: CVCPDataset, batch_size: int, crop: int = 64,
                 seed: int = 4, zero_mvl1: Optional[bool] = None,
                 augment: bool = True):
        self.ds = ds
        self.b = batch_size
        self.crop = crop
        self.rng = np.random.RandomState(seed)
        self.augment = augment
        self.zero_mvl1 = (ds.cfg.zero_mvl1_in_train
                          if zero_mvl1 is None else zero_mvl1)
        self.n = ds.cfg.nframes

    def _expand_center_mv_ra(self, mv0: np.ndarray, mv1: np.ndarray) -> np.ndarray:
        """Random-Access bidirectional expansion (`opt/data_RA_bi.py:496-528`):
        backward flow from mvl0/(-refoff), forward flow from mvl1/refoff,
        cross-complemented where either side is unavailable (refoff == -99),
        scaled outward; both mvl0s and mvl1s get the SAME tensor, /4 /32."""
        n = self.n
        c = n // 2
        out = np.zeros((n, *mv0.shape[:2], 2), np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            bx = mv0[:, :, 0] / (mv0[:, :, 2] * -1.0)
            by = mv0[:, :, 1] / (mv0[:, :, 2] * -1.0)
            fx = mv1[:, :, 0] / mv1[:, :, 2]
            fy = mv1[:, :, 1] / mv1[:, :, 2]
        m0u = mv0[:, :, 2] == -99
        m1u = mv1[:, :, 2] == -99
        out[c - 1, :, :, 0] = np.where(~np.isnan(bx), bx, 0)
        out[c - 1, :, :, 1] = np.where(~np.isnan(by), by, 0)
        out[c + 1, :, :, 0] = np.where(~np.isnan(fx), fx, 0)
        out[c + 1, :, :, 1] = np.where(~np.isnan(fy), fy, 0)
        out[c - 1][m0u] = -out[c + 1][m0u]
        out[c + 1][m1u] = -out[c - 1][m1u]
        for d in range(2, c + 1):
            out[c - d] = out[c - 1] * d
            out[c + d] = out[c + 1] * d
        return out / 4.0 / 32.0

    def _expand_center_mv(self, mv_field: np.ndarray) -> np.ndarray:
        """(h, w, 3) xy-swapped field -> (nframes, h, w, 2), /4 then /32
        (Augment `opt/data_LD_bi.py:456-489` + trainer `train_LD_37.py:367`)."""
        n = self.n
        c = n // 2
        out = np.zeros((n, *mv_field.shape[:2], 2), np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            fx = mv_field[:, :, 0] / (mv_field[:, :, 2] * -1.0)
            fy = mv_field[:, :, 1] / (mv_field[:, :, 2] * -1.0)
        out[c - 1, :, :, 0] = np.where(~np.isnan(fx), fx, 0)
        out[c - 1, :, :, 1] = np.where(~np.isnan(fy), fy, 0)
        for d in range(2, c + 1):
            out[c - d] = out[c - 1] * d
        for d in range(1, c + 1):
            out[c + d] = out[c - 1] * -d
        return out / 4.0 / 32.0

    def sample_batch(self) -> dict:
        b, n, cr = self.b, self.n, self.crop
        ds, r = self.ds, self.rng
        s_t, h, w = ds.lr.shape[1:4]
        lrs = np.empty((b, n, cr, cr, 1), np.float32)
        hrs = np.empty((b, 4 * cr, 4 * cr, 1), np.float32)
        pms = np.empty_like(lrs)
        rms = np.empty_like(lrs)
        ufs = np.empty_like(lrs)
        mv0s = np.empty((b, n, cr, cr, 2), np.float32)
        mv1s = np.empty((b, n, cr, cr, 2), np.float32)
        qps = np.empty((b, n), np.float32)
        for k in range(b):
            s = r.randint(0, len(ds))
            start = r.randint(0, s_t - n + 1) if s_t > n else 0
            # per-frame QP, /52 as the reference ToTensor does
            # (`opt/data_LD_bi.py:218,350`)
            qps[k] = ds.qp[s, start:start + n].astype(np.float32) / 52.0
            center = start + n // 2
            top = r.randint(0, h - cr) if h > cr else 0
            left = r.randint(0, w - cr) if w > cr else 0
            sl = np.s_[start:start + n, top:top + cr, left:left + cr]
            lr = ds.lr[s][sl].astype(np.float32) / 255.0
            hr = ds.hr[s, center, top * 4:(top + cr) * 4,
                       left * 4:(left + cr) * 4].astype(np.float32) / 255.0
            pm = ds.pm[s][sl].astype(np.float32) / 255.0
            rm = ds.rm[s][sl].astype(np.float32) / 255.0
            uf = ds.uf[s][sl].astype(np.float32) / 255.0
            mv0 = ds.mv0[s, center, top:top + cr, left:left + cr].astype(np.float32)
            mv1 = ds.mv1[s, center, top:top + cr, left:left + cr].astype(np.float32)
            # xy swap happens before flips (`opt/data_LD_bi.py:384-385`)
            mv0 = mv0[..., [1, 0, 2]]
            mv1 = mv1[..., [1, 0, 2]]
            if self.augment:
                hf, vf, rot = (r.rand() < 0.5, r.rand() < 0.5, r.rand() < 0.5)
                mv0 = augment_mv(mv0[None], hf, vf, rot)[0]
                mv1 = augment_mv(mv1[None], hf, vf, rot)[0]

                def geo(x):
                    if hf:
                        x = x[..., ::-1]
                    if vf:
                        x = x[..., ::-1, :]
                    if rot:
                        x = np.swapaxes(x, -2, -1)
                    return np.ascontiguousarray(x)

                lr, pm, rm, uf = geo(lr), geo(pm), geo(rm), geo(uf)
                hr = geo(hr)
            lrs[k, ..., 0] = lr
            hrs[k, ..., 0] = hr
            pms[k, ..., 0] = pm
            rms[k, ..., 0] = rm
            ufs[k, ..., 0] = uf
            if self.ds.cfg.coding_cfg == "RA":
                mv0s[k] = self._expand_center_mv_ra(mv0, mv1)
                mv1s[k] = mv0s[k]
            else:
                mv0s[k] = self._expand_center_mv(mv0)
                mv1s[k] = (np.zeros_like(mv0s[k]) if self.zero_mvl1
                           else self._expand_center_mv(mv1))
        return {"lrs": lrs, "mvs0": mv0s, "mvs1": mv1s, "pms": pms,
                "rms": rms, "ufs": ufs, "hr": hrs, "qp": qps}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample_batch()

    def prefetch(self, depth: int = 2) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=depth)

        def worker():
            while True:
                q.put(self.sample_batch())

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            yield q.get()

"""Batched streaming inference engine (counterpart of
``cdfo_tpu/infer/engine.py``).

The spatial-compensate block (EGLA + the ``conv_expand_fea_r`` projection)
and the prior expansions depend only on the neighbour frame, not on the
window it appears in. The engine computes them once per frame into device
ring buffers and runs the centre-dependent work (MV warp, dual attention,
fusion, trunk, head) for ``k`` output frames per step.

FPS protocol: frames / (device time of the forward work), frame 0's
bootstrap embed included: every input is staged on the device before the
timer; the bootstrap and all steps are dispatched back to back; one
``torch.cuda.synchronize()`` ends the timed region.

Untimed (served) mode overlaps the host with the card, as the JAX engine
does: step j is dispatched, its uint8 frames start back to the host, and
step j+1's inputs are prepared and uploaded while the card runs step j;
step j's frames are read only then. On a GPU the uploads leave pinned host
buffers on an upload stream (``non_blocking``), an event orders each
upload before the step that reads it, and the frames come back through
pinned buffers on a download stream. The frames equal the timed mode's
bit for bit: the same kernels run in the same order on the compute
stream.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.mv import modify_mv_for_end_frames, mv2mvs
from .pipeline import SequenceData, crop_sr_output


class BatchedStreamingEngine:
    """k-frame batched streaming with per-frame compensation ring buffers.
    Runs on the device that holds ``model``'s parameters. Under
    ``mask_mode="sample"`` each ``compensate_frames`` call (the bootstrap's
    and every step's) draws its gumbel noise from ``generator`` (on that
    device; seeded with 0 if not given), which every ``run_sequence``
    restarts from the state it had here, as the JAX engine restarts from
    its ``mask_rng``: timed and untimed runs draw the same noise. It runs
    the CVSR_V8 family (V8 and its ablations), whose ``compensate_frames``
    and ``align_reconstruct`` it calls; the other models run per window
    (``StreamingInferencer``)."""

    def __init__(self, model, k: int = 4, nframes: int = 7,
                 generator: torch.Generator | None = None):
        if not model.cfg.v8_family:
            raise ValueError(
                f"BatchedStreamingEngine runs the CVSR_V8 family; "
                f"{model.cfg.name} runs per window through "
                "infer.pipeline.StreamingInferencer")
        self.model = model
        self.k = k
        self.n = nframes
        self.device = next(model.parameters()).device
        self.generator = None
        if model.cfg.mask_mode == "sample":
            self.generator = generator or torch.Generator(
                device=self.device).manual_seed(0)
            self._generator_state = self.generator.get_state()
        # modular ring geometry: capacity >= k+6, a multiple of k so every
        # step's k-frame write is one contiguous slice; logical frame
        # position p lives in slot (p + S) % L
        self._L = k * (-(-(k + nframes - 1) // k))
        self._S = (k - (nframes // 2)) % k
        self._copies = {}   # upload and download streams, made at first use

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _put(self, arrays):
        """Host arrays on the device. On a GPU: uploaded from pinned
        buffers on the upload stream; the compute stream waits for them
        before any work enqueued after this call."""
        hosts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return tuple(h.to(self.device) for h in hosts)
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream("up")
        with torch.cuda.stream(copy):
            out = tuple(h.pin_memory().to(self.device, non_blocking=True)
                        for h in hosts)
        for t in out:
            t.record_stream(compute)
        compute.wait_stream(copy)
        return out

    def _fetch(self, sr8):
        """Starts the copy of a step's uint8 frames to the host; returns a
        function that waits for it and gives the numpy array."""
        if self.device.type != "cuda":
            return sr8.numpy
        copy = self._copy_stream("down")
        copy.wait_stream(torch.cuda.current_stream(self.device))
        host = torch.empty(sr8.shape, dtype=sr8.dtype, pin_memory=True)
        with torch.cuda.stream(copy):
            host.copy_(sr8, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        sr8.record_stream(copy)

        def wait():
            done.synchronize()
            return host.numpy()
        return wait

    def _copy_stream(self, way: str):
        if way not in self._copies:
            self._copies[way] = torch.cuda.Stream(self.device)
        return self._copies[way]

    # -- host-side input prep (outside the timed region) -----------------

    def _frame_inputs(self, data: SequenceData, frames):
        """Per-frame inputs for a list of (already clamped) frame indices;
        priors use the reference's max(1, i) I-frame rule."""
        pidx = [max(1, f) for f in frames]
        lrs = data.lr[list(frames)][..., None].astype(np.float32)
        pms = data.pm[pidx][..., None].astype(np.float32)
        rms = data.rm[pidx][..., None].astype(np.float32)
        ufs = data.uf[pidx][..., None].astype(np.float32)
        return lrs, pms, rms, ufs

    def _center_mvs(self, data: SequenceData, center: int):
        t = data.num_frames
        h = data.lr.shape[1]
        ci = min(max(1, center), t - 1)
        mvs1 = mv2mvs(data.mvl1[ci], self.n)
        modify_mv_for_end_frames(min(center, t - 1), mvs1, t)
        if mvs1.shape[1] != h:
            mvs1 = np.pad(mvs1, ((0, 0), (0, h - mvs1.shape[1]),
                                 (0, 0), (0, 0)))
        keep = [p for p in range(self.n) if p != self.n // 2]
        return mvs1[keep]  # (N-1, H, W, 2)

    def _own(self, centers: list) -> list:
        """Hook: the centres of a step that this engine computes and whose
        new frames it compensates (here all k; a rank's share in
        ``parallel.serving.ShardedServingEngine``)."""
        return centers

    def _gather(self, feats):
        """Hook between a step's compensation and its ring write: the new
        frames' (l1, fea_i, ufs prior) for all k centres (here as they are;
        every rank's in rank order in the sharded engine)."""
        return feats

    def _stage(self, data: SequenceData, j: int):
        """Host prep + device upload of step j's inputs for the centres
        this engine computes (``_own``)."""
        half, t = self.n // 2, data.num_frames
        L, S = self._L, self._S
        centers = self._own(list(range(j, j + self.k)))
        new_frames = [min(max(c + half, 0), t - 1) for c in centers]
        ninp = self._frame_inputs(data, new_frames)
        mvs = np.stack([self._center_mvs(data, c) for c in centers])
        center_lr = data.lr[[min(c, t - 1) for c in centers]][..., None]
        # modular ring slots; ring contents are frame-clamped at write time,
        # so logical positions index directly
        poffs = [p for p in range(self.n) if p != half]
        idx = np.array([[(c - half + p + S) % L for p in poffs]
                        for c in centers], np.int64)
        cidx = np.array([(c + S) % L for c in centers], np.int64)
        slot0 = (j + half + S) % L
        staged = self._put((*ninp, mvs.astype(np.float32),
                            center_lr.astype(np.float32), idx, cidx))
        return staged, slot0

    # -- device work ------------------------------------------------------

    def _compensate(self, lrs, pms, rms, ufs):
        return self.model.compensate_frames(lrs, pms, rms, ufs,
                                            generator=self.generator)

    def _boot(self, binp, bslots):
        """Compensate frames [-k-3 .. 2] (clamped) and scatter them into
        zeroed rings, so the first step's write leaves the rings covering
        [-3 .. k+2]."""
        rings = []
        for feat in self._compensate(*binp):
            ring = feat.new_zeros((self._L,) + feat.shape[1:])
            ring.index_copy_(0, bslots, feat)
            rings.append(ring)
        return rings

    def _step(self, rings, staged, slot0):
        lrs, pms, rms, ufs, mvs, center_lr, idx, cidx = staged
        ring_l1, ring_fi, ring_uf = rings
        new = self._gather(self._compensate(lrs, pms, rms, ufs))
        # in-place slot writes: the JAX engine donates the ring buffers to
        # the step, so its dynamic_update_slice also updates in place
        for ring, feat in zip(rings, new):
            ring[slot0:slot0 + self.k].copy_(feat)
        sr = self.model.align_reconstruct(ring_l1[cidx], center_lr, ring_fi,
                                          ring_uf[idx], mvs, idx)
        # quantise on the device, truncating as the reference does
        # (clamp(0, 1) * 255, then a cast to uint8)
        return (sr[..., 0].clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    def _stage_boot(self, data: SequenceData):
        """Host prep + device upload of the bootstrap's inputs and ring
        slots."""
        k, half, t = self.k, self.n // 2, data.num_frames
        boot_pos = range(-k - half, half)
        binp = self._put(self._frame_inputs(
            data, [min(max(f, 0), t - 1) for f in boot_pos]))
        bslots = torch.tensor([(p + self._S) % self._L for p in boot_pos],
                              device=self.device)
        return binp, bslots

    def stage_sequence(self, data: SequenceData):
        """Every input of ``data`` on the device, as the timed run stages
        it before its timer: (the bootstrap's, [each step's])."""
        return (self._stage_boot(data),
                [self._stage(data, j) for j in range(0, data.num_frames,
                                                     self.k)])

    def run_staged(self, boot, steps):
        """The device work of a staged sequence (``stage_sequence``): the
        bootstrap, then every step. Returns (the rings, [uint8 SR
        (k, sH, sW) of each step]); with no steps, the rings as the first
        step finds them."""
        rings = self._boot(*boot)
        return rings, [self._step(rings, *st) for st in steps]

    @torch.inference_mode()
    def run_sequence(self, data: SequenceData, collect_timing: bool = False):
        """Returns (sr uint8 (T, sH, sW), fps or None). With
        ``collect_timing`` the timer covers the bootstrap and every step and
        divides the full frame count."""
        if self.generator is not None:
            self.generator.set_state(self._generator_state)
        k, t = self.k, data.num_frames
        starts = list(range(0, t, k))
        out_frames = [None] * t

        def collect(j, fetched):
            sr_np = fetched()
            for b, c in enumerate(range(j, j + k)):
                if c < t:
                    out_frames[c] = crop_sr_output(sr_np[b])

        if collect_timing:
            boot, steps = self.stage_sequence(data)
            self._sync()
            t0 = time.perf_counter()
            _, srs = self.run_staged(boot, steps)
            self._sync()
            total = time.perf_counter() - t0
            for j, sr8 in zip(starts, srs):
                collect(j, self._fetch(sr8))
            return np.stack(out_frames), t / total

        rings = self._boot(*self._stage_boot(data))
        staged = self._stage(data, starts[0])
        for i, j in enumerate(starts):
            fetched = self._fetch(self._step(rings, *staged))
            if i + 1 < len(starts):   # host prep and upload under step j
                staged = self._stage(data, starts[i + 1])
            collect(j, fetched)
        return np.stack(out_frames), None

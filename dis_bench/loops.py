"""The two loops that drive the program: a closed loop of batch calls
(`kind: batch`, `dis_flow_batched`) and a closed loop of warm steps over
live streams (`kind: stream`, `dis_step_warm`). Each makes its inputs
from the seed, warms up, runs the measured window, runs a short stretch
under the profiler, keeps a sample of what the window produced, drawn
from the seed, and compares it with the plain reference afterwards.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from dis_bench import geometry
from dis_bench.traffic import synth


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of `size` of the items offered, drawn by `rng`
    (Algorithm R): whichever items a window reaches, each is kept with
    the same chance."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0

    def wants(self) -> int:
        """The slot the next item takes, or -1 to drop it."""
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else -1


def spread_sample(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """k of the indices 0..n-1, one drawn from each of k equal ranges, in
    order: every part of a batch is in the sample, so a fault that leaves
    out a half (or any range of n / k or more) is always seen."""
    edges = [n * i // k for i in range(k + 1)]
    return np.array([int(rng.integers(edges[i], edges[i + 1]))
                     for i in range(k)])


def _flow_stats(prog: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(largest |difference| of a component in px, mean endpoint error in
    px) of one or more flows (..., H, W, 2); a non-finite value reads
    inf."""
    d = (prog.double() - ref.double())
    if not bool(torch.isfinite(d).all()):
        return float("inf"), float("inf")
    epe = torch.sqrt((d * d).sum(-1))
    return float(d.abs().max()), float(epe.mean())


class Loop:
    """What both loops share: the traffic file, the configuration's
    parameters for the program (`prog_params`) and for the reference
    (`params`), the padded frame size, and the entry looked up on the
    port's module at every call."""

    def __init__(self, traffic: dict, params: geometry.Params, prog_params,
                 seed: int, device):
        from of_dis_tpu_torch.models import dis

        self.dis = dis
        self.traffic, self.params, self.prog_params = traffic, params, \
            prog_params
        self.seed, self.device = seed, device
        self.h, self.w = traffic["height"], traffic["width"]
        self.full_h, self.full_w = geometry.padded_size(
            self.h, self.w, params.sc_f + 1)
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.spans: List[Tuple[float, float]] = []   # host dispatch spans
        self.steps: List[float] = []    # a stream window's step times, s

    def pairs_per_call(self) -> int:
        raise NotImplementedError


class BatchLoop(Loop):
    """Calls of `batch` pairs back to back, no synchronize between them,
    alternating over two seeded sets of pairs, so no call sees the inputs
    of the call before it."""

    kind = "batch"
    input_sets = 2

    def pairs_per_call(self) -> int:
        return self.traffic["batch"]

    def setup(self) -> None:
        t0 = time.perf_counter()
        g = synth.generator(self.seed, self.device)
        self.sets = [synth.make_pairs(self.traffic["batch"], self.h, self.w,
                                      g, self.device, self.full_h,
                                      self.full_w)
                     for _ in range(self.input_sets)]
        sync()
        t1 = time.perf_counter()
        for s in self.sets:               # every shape of the window
            self.call(0, s)
        sync()
        self.setup_parts = {"inputs_s": t1 - t0,
                            "warm_up_s": time.perf_counter() - t1}
        self.n = 0

    def call(self, i: int, s=None):
        a, b = s if s is not None else self.sets[i % len(self.sets)]
        return self.dis.dis_flow_batched(a, b, self.prog_params,
                                         self.full_w, self.full_h,
                                         device=self.device)

    def window(self, seconds: float) -> dict:
        keep = Reservoir(self.traffic["check_calls"], self.rng)
        k = self.traffic["check_pairs"]
        self.kept = {}
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            out = self.call(self.n)
            self.spans.append((s, time.perf_counter()))
            slot = keep.wants()
            if slot >= 0:
                idx = spread_sample(out.shape[0], k, self.rng)
                self.kept[slot] = (self.n % len(self.sets), idx,
                                   out.index_select(0, torch.as_tensor(
                                       idx, device=out.device)))
            del out
            self.n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        return {"calls": self.n, "pairs": self.n * self.traffic["batch"],
                "wall_s": wall,
                "pairs_per_s": self.n * self.traffic["batch"] / wall}

    def stretch(self, calls: int) -> None:
        for _ in range(calls):
            self.call(self.n)
            self.n += 1
        sync()

    def check_inputs(self):
        """The sampled pairs' inputs, then the program's state freed."""
        todo = [(set_i, idx, out) for set_i, idx, out in self.kept.values()]
        inputs = []
        for set_i, idx, out in todo:
            a, b = self.sets[set_i]
            t = torch.as_tensor(idx, device=a.device)
            inputs.append((a.index_select(0, t), b.index_select(0, t), out))
        del self.sets, self.kept
        return inputs

    def check(self, reference, inputs, block: int) -> Dict[str, float]:
        worst_max = worst_epe = 0.0
        for a, b, out in inputs:
            for lo in range(0, a.shape[0], block):
                r = reference.flow(a[lo:lo + block], b[lo:lo + block],
                                   self.params)
                for j in range(r.shape[0]):
                    mx, epe = _flow_stats(out[lo + j], r[j])
                    worst_max, worst_epe = max(worst_max, mx), \
                        max(worst_epe, epe)
        return {"flow_max_abs_px": worst_max, "flow_mean_epe_px": worst_epe}


def pingpong(step: int, frames: int) -> Tuple[int, int]:
    """The frames (first, second) of a step that walks a video forward,
    then back, then forward again: every pair two consecutive frames."""
    r = step % (2 * (frames - 1))
    if r < frames - 1:
        return r, r + 1
    i = 2 * (frames - 1) - r
    return i, i - 1


class StreamLoop(Loop):
    """Warm steps over `streams` live videos, each step one
    `dis_step_warm` over the next pair of every stream (ping-pong over
    its frames), the carry chained, each step waiting for the one before
    (a synchronize after every step)."""

    kind = "stream"

    def pairs_per_call(self) -> int:
        return self.traffic["streams"]

    def setup(self) -> None:
        t0 = time.perf_counter()
        g = synth.generator(self.seed, self.device)
        self.frames = synth.make_videos(
            self.traffic["streams"], self.traffic["frames"], self.h, self.w,
            g, self.device, self.full_h, self.full_w)
        sync()
        t1 = time.perf_counter()
        carry = self.zero_carry()
        for k in range(2):                 # a cold and a warm step
            _, carry = self.call(k, carry)
        sync()
        self.setup_parts = {"inputs_s": t1 - t0,
                            "warm_up_s": time.perf_counter() - t1}
        self.n = 0
        self.carry = self.zero_carry()

    def zero_carry(self):
        return self.dis.warm_carry_init(self.traffic["streams"],
                                        self.prog_params, self.full_w,
                                        self.full_h, device=self.device)

    def call(self, k: int, carry):
        i, j = pingpong(k, self.traffic["frames"])
        return self.dis.dis_step_warm(self.frames[i], self.frames[j],
                                      self.prog_params, self.full_w,
                                      self.full_h, carry, device=self.device)

    def window(self, seconds: float) -> dict:
        s_idx = spread_sample(self.traffic["streams"],
                              self.traffic["check_streams"], self.rng)
        self.s_idx = torch.as_tensor(s_idx, device=self.device)
        keep = Reservoir(self.traffic["check_steps"], self.rng)
        self.kept: Dict[int, tuple] = {}
        prev = None
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            flow, self.carry = self.call(self.n, self.carry)
            r = time.perf_counter()
            mine = flow.index_select(0, self.s_idx)
            slot = -1 if self.n == 0 else keep.wants()   # -1: the first
            if self.n == 0 or slot >= 0:
                self.kept[slot] = (self.n, prev, mine,
                                   self.carry.index_select(0, self.s_idx))
            prev = mine
            del flow
            sync()
            e = time.perf_counter()
            self.spans.append((s, r))
            self.steps.append(e - s)
            self.n += 1
            if e - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        pairs = self.n * self.traffic["streams"]
        return {"calls": self.n, "pairs": pairs, "wall_s": wall,
                "pairs_per_s": pairs / wall}

    def stretch(self, calls: int) -> None:
        for _ in range(calls):
            _, self.carry = self.call(self.n, self.carry)
            sync()
            self.n += 1

    def check_inputs(self):
        """The sampled streams' videos, then the program's state freed."""
        vids = self.frames.index_select(1, self.s_idx)
        del self.frames, self.carry
        return vids

    def ref_carry(self, reference, prev, vids, lo: int, block: int):
        """The warm start of a kept step's streams [lo, lo + block): the
        carry the reference works out of the program's flow of the step
        before, or zero at the first step."""
        if prev is not None:
            return reference.carry_of(prev[lo:lo + block], self.params.sc_f)
        k = 2 ** (self.params.sc_f + 1)
        return torch.zeros((vids[0, lo:lo + block].shape[0],
                            self.full_h // k, self.full_w // k, 2),
                           dtype=torch.float32, device=vids.device)

    def check(self, reference, vids, block: int) -> Dict[str, float]:
        """Each kept step of the sampled streams against the reference's
        step from the same frames, warm-started from the carry that the
        reference works out of the program's flow of the step before
        (from zero at the first step); and the carry the program returned
        against the one the reference works out of the program's flow of
        that step."""
        worst_max = worst_epe = worst_carry = 0.0
        for k, prev, out, carry in self.kept.values():
            i, j = pingpong(k, self.traffic["frames"])
            for lo in range(0, vids.shape[1], block):
                r = reference.flow(vids[i, lo:lo + block],
                                   vids[j, lo:lo + block], self.params,
                                   self.ref_carry(reference, prev, vids, lo,
                                                  block))
                for n in range(r.shape[0]):
                    mx, epe = _flow_stats(out[lo + n], r[n])
                    worst_max, worst_epe = max(worst_max, mx), \
                        max(worst_epe, epe)
            worst_carry = max(worst_carry, _flow_stats(
                carry, reference.carry_of(out, self.params.sc_f))[0])
        return {"flow_max_abs_px": worst_max, "flow_mean_epe_px": worst_epe,
                "carry_max_abs_px": worst_carry}


KINDS = {"batch": BatchLoop, "stream": StreamLoop}

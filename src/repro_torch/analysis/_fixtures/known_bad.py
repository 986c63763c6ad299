# Known-bad corpus for `python -m repro_torch.analysis --selftest`.
#
# Every RA rule must fire on this file — it is the analyzer's regression
# fixture, never imported and never executed (the `_fixtures` directory
# is excluded from normal analysis runs and from packaging). Each block
# below reproduces one bug class the rules exist to catch in the port's
# own idiom, next to its clean counterpart; keep the blocks minimal and
# labelled so a selftest failure points at the rule that regressed.
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models import decode_step, forward
from repro_torch.optim import adamw_update
from repro_torch.training import train_step


# --- RA001: alias across an in-place update --------------------------------

def ra001_stale_alias(cfg, rl, tc, state, batch):
    before = state.params["embed"]            # an alias, not a copy
    state, metrics = train_step(cfg, rl, tc, state, batch)
    moved = state.params["embed"] - before    # RA001: `before` is new now
    return moved, metrics


def ra001_clone_is_clean(cfg, rl, tc, state, batch):
    before = state.params["embed"].clone()    # ok: a copy
    state, metrics = train_step(cfg, rl, tc, state, batch)
    return state.params["embed"] - before, metrics


class Learner:
    def __init__(self, state, tc):
        self.state = state                    # RA001: the caller's tree
        self.tc = tc

    def update(self, grads, lr):
        adamw_update(self.tc, grads, self.state.opt, self.state.params, lr)


# --- RA002: launch-key hygiene ------------------------------------------

@dataclasses.dataclass
class Bucket:
    width: int = 1


@functools.lru_cache(maxsize=8)
def ra002_cached_by_plain_dataclass(bucket: Bucket):   # RA002: unhashable
    return bucket.width


_GRAPH_CACHE = {}


def ra002_list_key(widths):
    return _GRAPH_CACHE.get([w for w in widths])    # RA002: a list key


def decode_ra002_hot(x):
    g = torch.Generator().manual_seed(0)      # RA002: built per call
    return x + torch.rand(x.shape, generator=g)


def ra002_library_per_iteration(paths):
    return [ctypes.CDLL(p) for p in paths] + [
        build.build() for _ in paths]         # RA002: built per iteration


@functools.lru_cache(maxsize=1)
def ra002_lru_cached_builder_is_clean():
    return ctypes.CDLL(str(build.build().path))   # ok: built once


# --- RA003: host sync in hot paths --------------------------------------

def step(cfg, params, tokens):
    logits, _, _ = forward(cfg, params, tokens)
    best = int(logits.argmax())               # RA003: host sync on result
    arr = np.asarray(logits)                  # RA003: host sync on result
    if (logits > 0).any():                    # RA003: a branch on the card
        best += 1
    return best, arr


def prefill_host_inputs(table, dev):
    return torch.as_tensor(table).to(dev)     # RA003: copy from the host


def report(cfg, params, pool, tok, pos):      # not a hot-path name
    logits, _ = decode_step(cfg, params, pool, tok, pos)
    return float(logits.max())                # ok


# --- RA004: kernel-wrapper contract -------------------------------------

def paged_decode_ref(q):
    return q


def _check(q):
    if q.dim() != 3:
        raise ValueError("q must be (B, Hq, D)")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


LAUNCHES = {"paged_decode": 0}


def ra004_bad_wrapper(q):
    out = torch.empty_like(q)
    lib = build.load()
    try:                                      # RA004: a launch in `try:`
        err = lib.paged_decode_launch(        # RA004: no current stream
            q.data_ptr(), out.data_ptr(), 0)  # RA004: a pointer unchecked
        if err != 0:                          # RA004: not through _raise_on
            raise RuntimeError("paged_decode_kernel failed")
    except RuntimeError:
        return paged_decode_ref(q)            # RA004: twin on a failure
    return out                                # RA004: launch never counted


def ra004_clean_wrapper(q):
    if q.device.type == "cpu":
        return paged_decode_ref(q)            # ok: the CPU branch
    _check(q)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_launch(q.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "paged_decode_kernel")
    build.count_launch(LAUNCHES, "paged_decode")
    return out


# --- RA005: unlocked cross-thread mutation ------------------------------

class SharedCounter:
    def __init__(self):
        self.count = 0
        self.items = []
        self._lock = threading.Lock()

    def bump(self):
        self.count += 1                       # RA005: no lock held
        self.items.append(self.count)         # RA005: no lock held

    def bump_locked(self):                    # exempt: caller holds lock
        self.count += 1

    def run(self):
        t = threading.Thread(target=self._loop)
        t.start()

    def _loop(self):
        while True:
            self.bump()


_ = (ra001_stale_alias, ra001_clone_is_clean, Learner,
     ra002_cached_by_plain_dataclass, ra002_list_key, decode_ra002_hot,
     ra002_library_per_iteration, ra002_lru_cached_builder_is_clean, step,
     prefill_host_inputs, report, ra004_bad_wrapper, ra004_clean_wrapper,
     SharedCounter)

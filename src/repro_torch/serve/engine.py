"""Batched serving on the port: prefill + greedy/temperature decode over the
KV cache, and the continuous-batching engine.

`ContinuousBatchingEngine` is the production decode loop on top of the same
model API: a fixed pool of KV slots, requests admitted (prefill-on-admit)
and retired per decode step, and hot weight swaps between steps. The port
runs eagerly, so a swap is a reference assignment and nothing is retraced;
in-flight requests continue on the new weights with zero loss.

Where the reference's functions return a new cache, the port's update it
in place (`models/layers.py:apply_attention`): a `ServeState` handed to
`serve_step` is consumed, and the engine's slot rows are overwritten where
they stand.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry

Tree = Any


class ServeState(NamedTuple):
    cache: Tree
    last_tokens: torch.Tensor  # [B, 1]
    index: int  # number of valid cache positions


def init_serve(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, window_override: int = 0, *,
               device: DeviceLike = None) -> ServeState:
    dev = resolve_device(device)
    cache = registry.init_cache(cfg, batch, max_len, dtype,
                                window_override=window_override, device=dev)
    last = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    return ServeState(cache, last, 0)


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            state: ServeState, *, window_override: int = 0) -> ServeState:
    logits, cache = registry.prefill(params, cfg, batch, state.cache,
                                     window_override=window_override)
    nxt = logits[:, -1:].argmax(-1)
    return ServeState(cache, nxt, batch["tokens"].shape[1])


def serve_step(params, cfg: ModelConfig, state: ServeState, *,
               window_override: int = 0, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[ServeState, torch.Tensor]:
    """Decode ONE token for the whole batch. Returns (state, token [B, 1]).
    With `temperature > 0` and a `generator`, samples from
    softmax(logits / temperature); otherwise greedy."""
    logits, cache = registry.decode_step(params, cfg, state.last_tokens,
                                         state.cache, state.index,
                                         window_override=window_override)
    lf = logits[:, -1].float()
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(lf / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)
    else:
        nxt = lf.argmax(-1)[:, None]
    return ServeState(cache, nxt, state.index + 1), nxt


def generate(params, cfg: ModelConfig, prompt: Dict[str, torch.Tensor],
             max_len: int, steps: int, *, dtype=torch.bfloat16,
             window_override: int = 0) -> torch.Tensor:
    """Simple eager generate loop: [B, steps] token ids (the prefill's token,
    then steps - 1 decoded ones), on the prompt's device."""
    B = prompt["tokens"].shape[0]
    st = init_serve(cfg, B, max_len, dtype, window_override=window_override,
                    device=prompt["tokens"].device)
    st = prefill(params, cfg, prompt, st, window_override=window_override)
    toks = [st.last_tokens]
    for _ in range(steps - 1):
        st, t = serve_step(params, cfg, st, window_override=window_override)
        toks.append(t)
    return torch.cat(toks, dim=1)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


class Request:
    """Host-side bookkeeping for one in-flight generation request."""

    __slots__ = ("rid", "prompt", "max_new", "tokens", "versions", "slot",
                 "submitted_step", "finished_step")

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: List[int] = []  # generated token ids
        # the param version each token was decoded under
        self.versions: List[int] = []
        self.slot: Optional[int] = None
        self.submitted_step: Optional[int] = None
        self.finished_step: Optional[int] = None


class StepEvents(NamedTuple):
    """What one `ContinuousBatchingEngine.step` did."""

    admitted: Tuple[int, ...]  # request ids that entered a slot (prefilled)
    retired: Tuple[int, ...]  # request ids completed this step
    tokens: Dict[int, int]  # rid -> token decoded this step
    version: int  # param version the decode ran under
    active: int  # slots occupied after the step


def _decode_fn(cfg: ModelConfig, window_override: int, params, last, cache,
               index, max_len: int):
    """One batched decode step over all slots; `index` is the per-slot [S]
    position vector. Idle slots decode garbage safely (their row is fully
    overwritten on the next admission) and their index is clamped so a long
    idle stretch can never scatter out of bounds."""
    logits, cache = registry.decode_step(params, cfg, last, cache, index,
                                         window_override=window_override)
    nxt = logits[:, -1].float().argmax(-1)[:, None]
    return cache, nxt, torch.clamp(index + 1, max=max_len - 1)


def _insert_fn(cache, pcache, slot: int) -> None:
    """Copy a batch=1 prefilled cache into row `slot` of the pooled cache, in
    place (the reference builds a new tree with `dynamic_update_index_in_dim`).
    The whole row of every layer's tensors is overwritten, whatever their
    names (GQA's k/v, full or ring; MLA's ckv/krope; the recurrent h and
    conv tail of an SSD or RG-LRU layer), the positions past the prompt with
    zeros."""
    for dst, src in zip(cache, pcache):
        for name in dst:
            dst[name][slot].copy_(src[name][0])


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode loop with hot weight swaps.

    * A fixed pool of `slots` KV-cache rows on the parameters' device;
      `submit` enqueues a request and `step` admits queued requests into free
      slots (prefill-on-admit: a batch=1 prefill, its cache row copied into
      the slot), decodes ONE token for every occupied slot in a single
      batched call, and retires requests that hit `max_new`.
    * `swap_params` installs a newly published param version BETWEEN decode
      steps: a host-side reference assignment, with zero in-flight request
      loss — slots keep their cache rows and continue under the new weights
      at the next step.
    * Greedy decode only (the benchmark/contract path). The recurrent
      families (SSD, RG-LRU) ride the same slot plumbing: their per-layer
      states are slot rows like a KV cache's. Encoder-decoder families are
      refused, as in the reference: they are served by `generate`.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 128, dtype=torch.float32,
                 window_override: int = 0, version: int = 0):
        if cfg.is_encdec:
            raise NotImplementedError(
                "continuous batching is decoder-only; serve encoder-decoder "
                "families with generate")
        if slots < 1 or max_len < 2:
            raise ValueError(f"bad pool: slots={slots} max_len={max_len}")
        self.cfg = cfg
        self.params = params
        self.version = int(version)
        self.slots = slots
        self.max_len = max_len
        self._dtype = dtype
        self._wo = window_override
        self.device = params["embed"].device
        self.cache = registry.init_cache(cfg, slots, max_len, dtype,
                                         window_override=window_override,
                                         device=self.device)
        self.index = torch.zeros((slots,), dtype=torch.long, device=self.device)
        self.last = torch.zeros((slots, 1), dtype=torch.long,
                                device=self.device)
        self._free: List[int] = list(range(slots))[::-1]
        self._active: Dict[int, Request] = {}  # slot -> request
        self._queue: deque = deque()
        self._done: Dict[int, Request] = {}
        self._next_rid = 0
        self.decode_steps = 0
        self.swaps = 0

    # ------------------------------------------------------------- interface

    def submit(self, prompt, max_new: int) -> int:
        """Enqueue a generation request. `prompt`: [L] int token ids with
        0 < L, L + max_new <= max_len. Returns the request id."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1 or prompt.size + max_new > self.max_len:
            raise ValueError(f"prompt_len={prompt.size} + max_new={max_new} "
                             f"exceeds max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new)
        req.submitted_step = self.decode_steps
        self._queue.append(req)
        return rid

    def swap_params(self, params, version: Optional[int] = None) -> int:
        """Install new weights between decode steps (never mid-step: `step`
        reads `self.params` exactly once). Versions must be monotone."""
        new_v = self.version + 1 if version is None else int(version)
        if new_v <= self.version:
            raise ValueError(f"non-monotone param version: "
                             f"{self.version} -> {new_v}")
        self.params = params
        self.version = new_v
        self.swaps += 1
        return new_v

    def poll(self, publisher) -> bool:
        """Adopt the publisher's current snapshot if it is newer than the
        engine's installed version. Returns True on a swap."""
        snap = publisher.snapshot()
        if snap is None or snap.version <= self.version:
            return False
        self.swap_params(snap.params, snap.version)
        return True

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def result(self, rid: int) -> Optional[Request]:
        """The completed request (None while queued or in flight)."""
        return self._done.get(rid)

    # ----------------------------------------------------------- decode loop

    def _prefill(self, prompt: np.ndarray):
        """Batch-1 prefill of one prompt into a fresh max_len cache. Returns
        (cache, first generated token [1])."""
        c = registry.init_cache(self.cfg, 1, self.max_len, self._dtype,
                                window_override=self._wo, device=self.device)
        tokens = torch.as_tensor(prompt, device=self.device)[None]
        logits, cache = registry.prefill(self.params, self.cfg,
                                         {"tokens": tokens}, c,
                                         window_override=self._wo)
        return cache, logits[:, -1].float().argmax(-1)

    def _admit(self) -> List[int]:
        admitted = []
        while self._free and self._queue:
            req = self._queue.popleft()
            slot = self._free.pop()
            L = int(req.prompt.size)
            pcache, nxt = self._prefill(req.prompt)
            _insert_fn(self.cache, pcache, slot)
            self.index[slot] = L
            self.last[slot] = nxt
            req.slot = slot
            # prefill emits the first generated token
            req.tokens.append(int(nxt[0]))
            req.versions.append(self.version)
            self._active[slot] = req
            admitted.append(req.rid)
        return admitted

    def _retire(self) -> List[int]:
        retired = []
        for slot, req in list(self._active.items()):
            if len(req.tokens) >= req.max_new:
                req.finished_step = self.decode_steps
                req.slot = None
                self._done[req.rid] = req
                del self._active[slot]
                self._free.append(slot)
                # park the freed slot at position 0; its row is garbage until
                # the next admission fully overwrites it
                self.index[slot] = 0
                self.last[slot] = 0
                retired.append(req.rid)
        return retired

    def step(self) -> StepEvents:
        """One engine iteration: retire finished requests, admit from the
        queue, then decode one token for every occupied slot (a single
        batched call under the currently installed params)."""
        retired = self._retire()
        admitted = self._admit()
        # a request whose max_new == 1 completes on its prefill token
        retired += self._retire()
        toks: Dict[int, int] = {}
        if self._active:
            self.cache, self.last, self.index = _decode_fn(
                self.cfg, self._wo, self.params, self.last, self.cache,
                self.index, self.max_len)
            self.decode_steps += 1
            out = self.last[:, 0].tolist()  # the per-step host sync point
            for slot, req in self._active.items():
                req.tokens.append(out[slot])
                req.versions.append(self.version)
                toks[req.rid] = out[slot]
        return StepEvents(tuple(admitted), tuple(retired), toks,
                          self.version, len(self._active))

    def drain(self, max_steps: int = 10_000) -> None:
        """Step until queue and slots are empty (tests / end-of-benchmark)."""
        for _ in range(max_steps):
            if not self._active and not self._queue:
                return
            self.step()
        raise RuntimeError("drain did not converge")

"""Async host-to-device prompt staging for the serve path.

The counterpart of ``repro/serve/staging.py``. A prompt is known the
moment its request is queued, usually several decode rounds before a
slot frees; :class:`PromptStager` starts its host-to-device copy then
(router ``submit``, the engine's ``run`` look-ahead, a rescue replay),
and ``take`` hands the device tensor to the prefill at admission, so the
admission does not wait for the copy.

On a CUDA device ``stage`` copies the prompt from a pinned host tensor
with ``non_blocking=True`` on a side stream of the stager's own and
records an event after the copy; ``take`` makes the consumer (current)
stream wait on that event and calls ``record_stream`` on the tensor, so
the caching allocator does not hand its memory to another tensor while
the prefill still reads it. On a CPU device nothing is pinned and the
tensor is made in place: that is the path the caller asked for.

The side stream runs copies only, never a kernel. So the decode
kernels' split counters (``kernels/attention/decode.py``,
``split_counters``) and the stream suite's scratch
(``kernels/stream/kernels.py``, ``_scratch``), one of each a device,
still serve one stream: the engine's.

The staged tensor holds exactly the int64 prompt ids the unstaged path
builds, so a prefill reads the same bits whether or not its prompt was
staged. ``take`` checks the staged entry against the prompt it is asked
for and stages on the spot on a miss or a mismatch (a rid reused with
another prompt never serves stale tokens). The queue is bounded
(``depth``): staging past it evicts the least recently staged entry.
"""

from __future__ import annotations

from collections import OrderedDict

import torch


class PromptStager:
    """Bounded prefetch queue of device-resident prompt token tensors.

    ``depth`` bounds how many prompts may be staged at once; staging past
    it evicts the least recently staged entry (that prompt then stages at
    admission). ``device`` is where the prefill reads the prompts.
    """

    def __init__(self, depth: int = 8, device="cuda"):
        self.depth = max(1, int(depth))
        self.device = torch.device(device)
        self._stream = None          # the copies' side stream, made at use
        # rid -> (prompt, device tensor, copy-done event or None)
        self._staged: OrderedDict = OrderedDict()
        self.staged = 0          # copies issued ahead of admission
        self.hits = 0            # admissions served from the queue
        self.misses = 0          # admissions that had to stage inline

    def _put(self, prompt: tuple) -> tuple:
        """Start one prompt's copy; returns ``(tensor, event)``."""
        host = torch.tensor([prompt], dtype=torch.int64)
        if self.device.type != "cuda":
            return host.to(self.device), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        host = host.pin_memory()
        with torch.cuda.stream(self._stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def stage(self, rid: str, prompt: tuple) -> bool:
        """Prefetch one prompt; returns True if a new copy was issued.

        A rid already staged with the same prompt is refreshed in recency
        order but not copied again. The call returns once the copy is
        enqueued.
        """
        prompt = tuple(prompt)
        hit = self._staged.get(rid)
        if hit is not None and hit[0] == prompt:
            self._staged.move_to_end(rid)
            return False
        while len(self._staged) >= self.depth:
            self._staged.popitem(last=False)
        self._staged[rid] = (prompt, *self._put(prompt))
        self.staged += 1
        return True

    def take(self, rid: str, prompt: tuple) -> torch.Tensor:
        """The staged ``(1, S)`` int64 device tensor for one admission.

        Pops the entry (a prompt is prefilled once). A missing or
        mismatched entry stages inline: the same tokens, without the head
        start. On a CUDA device the current stream waits for the copy.
        """
        prompt = tuple(prompt)
        hit = self._staged.pop(rid, None)
        if hit is not None and hit[0] == prompt:
            self.hits += 1
            _, dev, done = hit
        else:
            self.misses += 1
            dev, done = self._put(prompt)
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            dev.record_stream(stream)
        return dev

    def discard(self, rid: str) -> None:
        """Drop one staged prompt (cancelled before admission)."""
        self._staged.pop(rid, None)

    def stats(self) -> dict:
        """Prefetch counters: staged, hits, misses and the queue's depth."""
        return {"staged": self.staged, "hits": self.hits,
                "misses": self.misses, "queued": len(self._staged)}

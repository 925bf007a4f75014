"""One writer, dispatched ahead: each call encodes ``stripes_per_call``
resident stripes in one ``encode_batch_words``, with at most ``depth``
calls queued on the device; the window ends when the device has finished
the last call. The resident stripes hold data cells only."""

from __future__ import annotations

import collections

import torch

from ecbench import roofline
from ecbench.harness import Done, clock


class Driver:
    def __init__(self, job):
        self.job = job
        self.per_call = int(job.traffic["stripes_per_call"])
        self.depth = int(job.traffic["depth"])

    def setup(self) -> None:
        job = self.job
        with job.phase("resident"):
            job.make_resident(job.k)
        with job.phase("codec_and_warm"):
            job.make_hold(lambda i: self.per_call * job.n * job.tw)
            self.codec = job.system(job.cfg, job.device)
            for c in range(self.depth + 1):
                self.codec.encode_batch_words(
                    self._chunk(c % job.mix.groups))

    def _chunk(self, group: int) -> torch.Tensor:
        return self.job.res[group * self.per_call:
                            (group + 1) * self.per_call]

    def window(self, run) -> None:
        job = self.job
        op = job.mix.request_kind
        useful = self.per_call * job.k * job.cell_bytes
        least = roofline.encode_least_bytes(job.k, job.r, job.cell_bytes,
                                            self.per_call)
        pending = collections.deque()
        submits = run.spans.setdefault("submit", [])
        i = 0
        job.slice.begin(clock)
        t0 = clock()
        deadline = t0 + job.seconds
        while clock() < deadline:
            job.slice.tick()
            if len(pending) >= self.depth:
                with job.span("ecbench.wait"):
                    job.dev.wait(pending.popleft())
            req = job.mix.request(i)
            words = self._chunk(req.group)
            ts = clock()
            try:
                with job.span("ecbench.submit"):
                    out = self.codec.encode_batch_words(words)
            except Exception as exc:  # counted as failed
                job.failures.append((i, repr(exc)))
                i += 1
                continue
            te = clock()
            submits.append((ts, te))
            if i in job.slot:
                job.hold[job.slot[i]].view(out.shape).copy_(out)
                job.got[i] = req
            pending.append(job.dev.event())
            run.done.append(Done(op, ts, te, useful, least))
            del out
            i += 1
        job.dev.sync()
        run.window_s = clock() - t0
        job.slice.end()
        run.attempted = i

    def drop(self) -> None:
        self.codec = None

    def answers(self):
        job = self.job
        for i, req in sorted(job.got.items()):
            data = self._chunk(req.group)
            expect = torch.cat([data, job.code.parity(data)], 1)
            yield job.hold[job.slot[i]].view(expect.shape), expect

"""A closed loop of ``clients`` clients, each with one request in flight
on a CUDA stream of its own: a request gathers the n - e surviving cells of
one block group from the resident codewords, rebuilds them with one
``reconstruct_batch_words`` and copies the answer's rows out. The resident
stripes hold data and parity cells.

Set-up plans every erasure pattern of at most ``warm_max_erasures`` cells,
runs one whole request of each erasure size on each client's stream, and
runs the loop for ``warm_seconds`` on requests of its own, far past the
window's in the seed's sequence, so that the window finds the allocator's
blocks of every stream in place.

One host thread launches for every client. It polls the event of each
request in flight in turn and stamps a request's end when its event is
first seen done, then launches that client's next request at once: a
request that finishes before an older one on another stream is seen when
it ends. Waiting clients thus take no host core and no interpreter lock
from the one that launches, as client threads would.
"""

from __future__ import annotations

import itertools

import torch

from ecbench import roofline
from ecbench.harness import Done, clock

# The first request index of the warm-up.
WARM_BASE = 10**9


class Driver:
    def __init__(self, job):
        self.job = job
        self.clients = int(job.traffic["clients"])

    def setup(self) -> None:
        job = self.job
        with job.phase("resident"):
            job.make_resident(job.n)
        with job.phase("codec_and_warm"):
            self.answer_words = job.stripes * job.mix.answer_rows * job.tw
            job.make_hold(lambda i: job.stripes * job.tw * len(
                job.mix.request(i).answer_rows))
            # One stream a client for the whole run: the allocator keeps
            # its blocks by stream, so the window reuses the warm-up's.
            self.streams = [job.dev.stream() for _ in range(self.clients)]
            self.scratch = [torch.empty(self.answer_words, dtype=torch.int32,
                                        device=job.device)
                            for _ in range(self.clients)]
            self.codec = job.system(job.cfg, job.device)
            self._warm()

    def _warm(self) -> None:
        job = self.job
        for lost in job.mix.patterns(int(job.traffic["warm_max_erasures"])):
            present = tuple(i for i in range(job.n) if i not in lost)
            self.codec.reconstruct_batch_words(
                job.res[:1].index_select(1, job.idx(present)),
                list(present))
            job.idx(lost)
        for j in range(job.k):
            job.idx((j,))
        for ci, stream in enumerate(self.streams):
            with job.dev.on(stream):
                for req in job.mix.shape_requests():
                    self._rebuild(req, self._dst(req.index, req, ci))
        job.dev.sync()
        self._loop(float(job.traffic["warm_seconds"]), WARM_BASE,
                   lambda *done: None)
        if job.failures:
            raise RuntimeError(f"warm-up request failed: {job.failures[0]}")

    def _dst(self, i, req, ci: int) -> torch.Tensor:
        """Where request ``i``'s answer goes: its slot of the held answers
        when it is checked, else the client's scratch."""
        job = self.job
        buf = job.hold[job.slot[i]] if i in job.slot else self.scratch[ci]
        e = len(req.answer_rows)
        return buf[:job.stripes * e * job.tw].view(job.stripes, e, job.tw)

    def _rebuild(self, req, dst: torch.Tensor) -> None:
        """Launch one request on the current stream, from the gather to the
        answer's copy."""
        job = self.job
        present = tuple(i for i in range(job.n) if i not in req.lost)
        g0 = req.group * job.stripes
        with job.span("ecbench.gather"):
            survivors = job.res[g0:g0 + job.stripes].index_select(
                1, job.idx(present))
        with job.span("ecbench.entry"):
            full = self.codec.reconstruct_batch_words(survivors,
                                                      list(present))
        with job.span("ecbench.answer"):
            torch.index_select(full, 1, job.idx(req.answer_rows), out=dst)

    def _loop(self, seconds: float, base: int, on_done) -> int:
        """The clients' closed loop (module doc) from request ``base`` on,
        until ``seconds`` have passed; ``on_done(i, req, t0, t1)`` is called
        for each request that came back. Returns how many were started."""
        job = self.job
        counter = itertools.count(base)
        deadline = clock() + seconds

        def launch(ci):
            while clock() < deadline:
                i = next(counter)
                req = job.mix.request(i)
                dst = self._dst(i, req, ci)
                t_a = clock()
                try:
                    with job.dev.on(self.streams[ci]):
                        self._rebuild(req, dst)
                        return i, req, t_a, job.dev.event()
                except Exception as exc:  # counted as failed
                    job.failures.append((i, repr(exc)))
            return None

        flight = [launch(ci) for ci in range(self.clients)]
        t_poll = clock()
        while any(f is not None for f in flight):
            for ci, f in enumerate(flight):
                if f is None or not job.dev.done(f[3]):
                    continue
                t_b = clock()
                job.add_span("ecbench.wait", t_poll, t_b)
                on_done(f[0], f[1], f[2], t_b)
                flight[ci] = launch(ci)
                t_poll = clock()
            job.slice.tick()
        return next(counter) - base

    def window(self, run) -> None:
        job = self.job
        op = job.mix.request_kind

        def done(i, req, t_a, t_b):
            useful = len(req.answer_rows) * job.stripes * job.cell_bytes
            least = roofline.rebuild_least_bytes(
                job.code.least_read(req.lost), len(req.lost),
                job.cell_bytes, job.stripes)
            run.done.append(Done(op, t_a, t_b, useful, least))
            if i in job.slot:
                job.got[i] = req

        job.slice.begin(clock)
        t0 = clock()
        run.attempted = self._loop(job.seconds, 0, done)
        run.window_s = clock() - t0
        job.slice.end()

    def drop(self) -> None:
        self.codec = None
        self.scratch = None

    def answers(self):
        """Each held answer beside the reference's rebuild of it from its
        basis of survivors (``reference.Code.basis``); the reference's
        rebuild is also held against the stored cells."""
        job = self.job
        for i, req in sorted(job.got.items()):
            blk = job.res[req.group * job.stripes:
                          (req.group + 1) * job.stripes]
            present = [x for x in range(job.n) if x not in req.lost]
            basis, R = job.code.rebuild_matrix(present, req.answer_rows)
            expect = job.code.rebuild(
                blk.index_select(1, job.idx(tuple(basis))), R)
            stored = blk.index_select(1, job.idx(req.answer_rows))
            if not torch.equal(expect, stored):
                raise RuntimeError(
                    f"the reference's rebuild of request {i} differs from "
                    "the stored cells: the reference is at fault")
            yield self._dst(i, req, 0), expect

"""Open-loop requests at a fixed rate: request i arrives at the time the
mix draws for it (``rate_per_s``, ``traffic.Mix.arrival``), whether or not
earlier requests have come back. A request runs as in ``closed_loop`` (the
gather of the survivors, one ``reconstruct_batch_words``, the answer's
copy) on one of ``streams`` CUDA streams, each with at most one request in
flight; an arrival that finds every stream busy waits on the host, in
arrival order. Its latency runs from its arrival to the moment its
completion is seen, the wait included. The window takes arrivals for
``seconds`` and then waits for every request that arrived in it.

Set-up is ``closed_loop``'s, with the open loop as its warm-up.
"""

from __future__ import annotations

import collections

from ecbench.drivers import closed_loop
from ecbench.harness import clock


class Driver(closed_loop.Driver):
    def __init__(self, job):
        self.job = job
        self.clients = int(job.traffic["streams"])

    def _loop(self, seconds: float, base: int, on_done) -> int:
        """Requests from ``base`` on, arriving for ``seconds``;
        ``on_done(i, req, t_arrival, t_seen)`` for each that came back.
        Returns how many arrived."""
        job = self.job
        mix = job.mix
        t_start = clock()
        deadline = t_start + seconds
        origin = mix.arrival(base)
        i = base
        t_next = t_start
        waiting = collections.deque()
        flight = [None] * self.clients
        t_poll = clock()
        while True:
            now = clock()
            while t_next <= now and t_next < deadline:
                waiting.append((i, mix.request(i), t_next))
                i += 1
                t_next = t_start + mix.arrival(i) - origin
            for ci, f in enumerate(flight):
                if f is not None and job.dev.done(f[3]):
                    t_b = clock()
                    job.add_span("ecbench.wait", t_poll, t_b)
                    on_done(f[0], f[1], f[2], t_b)
                    flight[ci] = None
                    t_poll = clock()
                if flight[ci] is None and waiting:
                    n, req, t_arr = waiting.popleft()
                    try:
                        with job.dev.on(self.streams[ci]):
                            self._rebuild(req, self._dst(n, req, ci))
                            flight[ci] = (n, req, t_arr, job.dev.event())
                    except Exception as exc:  # counted as failed
                        job.failures.append((n, repr(exc)))
                    t_poll = clock()
            if (t_next >= deadline and not waiting
                    and all(f is None for f in flight)):
                return i - base
            job.slice.tick()

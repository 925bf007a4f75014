"""Subprocess end-to-end: real ``python -m noise_ec_tpu_torch.host.cli``
nodes, shaped like ``tests/test_cli_e2e.py``: OS pipes for the REPL, real
sockets between nodes, log scraping for the receive side's "message from"
line (main.go:92). Two port nodes over TCP and over KCP, one on
``-backend device -device cpu`` and one on ``-backend numpy``, exchange a
line each way and a ``/send`` of a file that spans chunks (and the
receiver's stats server answers ``/metrics``, ``/healthz`` and
``/events``); two store-backed nodes serve an object PUT over HTTP to
one from the other, also after a restart from the store directory, one
node runs with all eight of those modules' flags, and a store-backed
node on the default ``-device cuda`` exits 1 without a card; a flag whose module is not ported yet exits with status 2;
and a port node and a reference node (``python -m noise_ec_tpu.host.cli
-backend numpy``) exchange a line each way over TCP — the wire interop."""

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

# The reference's margins (tests/test_cli_e2e.py): every wait is on an
# event, so a generous ceiling costs nothing when the nodes are healthy.
NODE_START_TIMEOUT = 60.0
REGISTRATION_TIMEOUT = 120.0
MESSAGE_TIMEOUT = 120.0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_ports(count: int) -> list[int]:
    socks, ports = [], []
    for _ in range(count):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


class Node:
    """One CLI subprocess with a line-buffered stderr scraper."""

    def __init__(self, module: str, port: int, *args: str,
                 peers: str = "", protocol: str = "tcp"):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("PYTHONPATH", None)
        argv = [sys.executable, "-m", module, "-port", str(port),
                "-host", "127.0.0.1", "-protocol", protocol, *args]
        if peers:
            argv += ["-peers", peers]
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
        )
        self.lines: list[str] = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._scrape, daemon=True)
        self._reader.start()

    def _scrape(self) -> None:
        for line in self.proc.stderr:
            with self._cond:
                self.lines.append(line)
                self._cond.notify_all()

    def wait_for(self, needle: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if needle in line:
                        return line
                remaining = deadline - time.monotonic()
                # A finished scraper means the node exited: no more lines.
                if remaining <= 0 or not self._reader.is_alive():
                    raise AssertionError(
                        f"timed out waiting for {needle!r} (rc "
                        f"{self.proc.poll()}); log so far:\n"
                        + "".join(self.lines[-40:])
                    )
                self._cond.wait(min(remaining, 0.5))

    def send_line(self, text: str) -> None:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def stop(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
            self.proc.wait(timeout=15)
        except Exception:  # noqa: BLE001 — teardown must not leak a node
            self.proc.kill()
            self.proc.wait(timeout=15)
        self._reader.join(timeout=5)


@pytest.fixture
def nodes():
    started: list[Node] = []

    def launch(*args, **kwargs) -> Node:
        n = Node(*args, **kwargs)
        started.append(n)
        return n

    yield launch
    for n in started:
        n.stop()


PORT_CLI = "noise_ec_tpu_torch.host.cli"
REF_CLI = "noise_ec_tpu.host.cli"
DEVICE_CPU = ("-backend", "device", "-device", "cpu")
NUMPY = ("-backend", "numpy")


@pytest.mark.parametrize("protocol", ["tcp", "kcp"])
def test_two_port_nodes_exchange_lines_and_a_file(nodes, tmp_path, protocol):
    """A (device backend, CPU plain versions) and B (numpy) exchange a
    line each way; B then receives A's /send of a file that spans three
    chunks, saved under its content hash."""
    pa, pb = _free_ports(2)
    recv = tmp_path / "recv"
    b = nodes(PORT_CLI, pb, *NUMPY, "-recv-dir", str(recv),
              "-metrics-port", "0", protocol=protocol)
    b.wait_for("listening for peers", NODE_START_TIMEOUT)
    metrics = b.wait_for("metrics endpoint on ", NODE_START_TIMEOUT)
    url = metrics.split("metrics endpoint on ")[1].split("/metrics")[0]
    a = nodes(PORT_CLI, pa, *DEVICE_CPU, "-chunk-bytes", "4096",
              peers=f"{protocol}://127.0.0.1:{pb}", protocol=protocol)
    a.wait_for("listening for peers", NODE_START_TIMEOUT)
    b.wait_for(f"registered peer {protocol}://127.0.0.1:{pa}",
               REGISTRATION_TIMEOUT)

    msg = f"hello from the port over {protocol}"
    a.send_line(msg)
    b.wait_for(f"message from {protocol}://127.0.0.1:{pa}: "
               f"{msg.encode().hex()}", MESSAGE_TIMEOUT)
    reply = "and back again, numpy to device"
    b.send_line(reply)
    a.wait_for(f"message from {protocol}://127.0.0.1:{pb}: "
               f"{reply.encode().hex()}", MESSAGE_TIMEOUT)

    payload = os.urandom(3 * 4096 - 100)
    src = tmp_path / "obj.bin"
    src.write_bytes(payload)
    a.send_line(f"/send {src}")
    a.wait_for("as 3 chunks", MESSAGE_TIMEOUT)
    name = hashlib.blake2b(payload, digest_size=8).hexdigest()
    b.wait_for(f"saved {len(payload)} bytes", MESSAGE_TIMEOUT)
    assert (recv / name).read_bytes() == payload

    # B's stats server: the plugin's counters, health and the event log.
    with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert "noise_ec_plugin_verified 2" in text
    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(url + "/events", timeout=10) as resp:
        assert set(json.loads(resp.read())) == {
            "node", "epoch", "next_since", "events"}


@pytest.mark.parametrize("flag", [["-trace-peers", "http://127.0.0.1:1"],
                                  ["-fleet-profile", "object=1"],
                                  ["-chaos-profile", "drop=0.1"],
                                  ["-federate-interval", "3"]])
def test_flag_of_an_unported_module_exits_2(flag):
    proc = subprocess.run(
        [sys.executable, "-m", PORT_CLI, *NUMPY, *flag],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        stdin=subprocess.DEVNULL,
    )
    assert proc.returncode == 2
    assert "not ported yet" in proc.stderr and flag[0] in proc.stderr


def test_help_lists_the_reference_flags():
    """The port's parser holds every flag of the reference's, item 5's
    included, plus -device; --help exits 0."""
    from noise_ec_tpu.host.cli import build_parser as ref_parser
    from noise_ec_tpu_torch.host.cli import build_parser

    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert flags(build_parser()) == flags(ref_parser()) | {"-device"}
    out = subprocess.run([sys.executable, "-m", PORT_CLI, "--help"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0 and "-device {cuda,cpu}" in out.stdout


def test_port_and_reference_nodes_exchange_lines(nodes):
    """The wire interop: a port node (device backend, CPU) and a
    reference node (numpy backend) exchange a line each way over TCP."""
    pp, pr = _free_ports(2)
    ref = nodes(REF_CLI, pr, *NUMPY)
    ref.wait_for("listening for peers", NODE_START_TIMEOUT)
    port = nodes(PORT_CLI, pp, *DEVICE_CPU, peers=f"tcp://127.0.0.1:{pr}")
    port.wait_for("listening for peers", NODE_START_TIMEOUT)
    ref.wait_for(f"registered peer tcp://127.0.0.1:{pp}",
                 REGISTRATION_TIMEOUT)

    msg = "port to reference"
    port.send_line(msg)
    ref.wait_for(f"message from tcp://127.0.0.1:{pp}: {msg.encode().hex()}",
                 MESSAGE_TIMEOUT)
    back = "reference to port"
    ref.send_line(back)
    port.wait_for(f"message from tcp://127.0.0.1:{pr}: {back.encode().hex()}",
                  MESSAGE_TIMEOUT)


def _object_url(node: Node) -> str:
    line = node.wait_for("object service on ", NODE_START_TIMEOUT)
    return line.split("object service on ")[1].split("/objects")[0]


def _get_object(url: str, timeout: float = MESSAGE_TIMEOUT) -> bytes:
    """GET with retries until the object's manifest has replicated."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def test_store_backed_nodes_serve_objects_across_a_restart(nodes, tmp_path):
    """Two port nodes (device backend, CPU) with a stripe store each,
    the object service and a scrubber: an object PUT over HTTP to A is
    served byte-identically by B, and again by B restarted from its
    store directory."""
    pa, pb = _free_ports(2)
    store_b = str(tmp_path / "b")
    args = ("-object-port", "0", "-scrub-interval", "1")
    b = nodes(PORT_CLI, pb, *DEVICE_CPU, "-store-dir", store_b, *args)
    url_b = _object_url(b)
    a = nodes(PORT_CLI, pa, *DEVICE_CPU, "-store-dir", str(tmp_path / "a"),
              *args, peers=f"tcp://127.0.0.1:{pb}")
    url_a = _object_url(a)
    b.wait_for(f"registered peer tcp://127.0.0.1:{pa}", REGISTRATION_TIMEOUT)
    payload = os.urandom(600_000)
    req = urllib.request.Request(url_a + "/objects/acme/big.bin",
                                 data=payload, method="PUT")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 201
        doc = json.loads(resp.read())
    assert doc["size"] == len(payload) and (doc["k"], doc["n"]) == (4, 6)
    assert _get_object(url_b + "/objects/acme/big.bin") == payload
    b.stop()
    b2 = nodes(PORT_CLI, pb, *DEVICE_CPU, "-store-dir", store_b,
               "-object-port", "0")
    url_b2 = _object_url(b2)
    b2.wait_for("stripes loaded", NODE_START_TIMEOUT)
    with urllib.request.urlopen(url_b2 + "/objects/acme/big.bin",
                                timeout=60) as resp:
        assert resp.read() == payload
    assert b.proc.returncode == 0


def test_store_node_on_the_card_exits_1_without_one(tmp_path):
    """-store-dir with the default -device cuda: no card, exit 1 with
    the codec's error; it never falls back to the host."""
    import torch

    if torch.cuda.is_available():  # pragma: no cover - a card's host
        pytest.skip("a CUDA device is present")
    (port,) = _free_ports(1)
    proc = subprocess.run(
        [sys.executable, "-m", PORT_CLI, "-port", str(port), "-host",
         "127.0.0.1", "-store-dir", str(tmp_path / "s"), "-object-port", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        stdin=subprocess.DEVNULL,
    )
    assert proc.returncode == 1
    assert "codec unavailable on cuda" in proc.stderr


def test_every_store_flag_starts_a_node(nodes, tmp_path):
    """One node with all eight store, placement and object-service flags
    set: the ring, the conversion loop and the tenants are up, and an
    object PUT to a configured tenant reads back byte-identically."""
    (port,) = _free_ports(1)
    tenants = tmp_path / "tenants.json"
    tenants.write_text(json.dumps({"tenants": {"acme": {
        "max_bytes": 1 << 30, "policy": "archive=lrc:8/2+2,age=3600"}}}))
    node = nodes(PORT_CLI, port, *DEVICE_CPU,
                 "-store-dir", str(tmp_path / "s"), "-object-port", "0",
                 "-scrub-interval", "1", "-announce-interval", "1",
                 "-object-cache-mb", "16", "-tenants", str(tenants),
                 "-convert-interval", "1",
                 "-topology", f"domain=d0:tcp://127.0.0.1:{port}")
    url = _object_url(node)
    node.wait_for("placement ring active: 1 failure domains",
                  NODE_START_TIMEOUT)
    node.wait_for("hot->archival conversion every 1s", NODE_START_TIMEOUT)
    node.wait_for("(1 tenants configured)", NODE_START_TIMEOUT)
    payload = os.urandom(100_000)
    req = urllib.request.Request(url + "/objects/acme/x.bin", data=payload,
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 201
    assert _get_object(url + "/objects/acme/x.bin") == payload

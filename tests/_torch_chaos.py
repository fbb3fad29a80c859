"""Fault-injection harness for the port's cluster tests (a copy of
tests/_chaos.py whose daemons are the port's).

Real faults, not mocks: :class:`DaemonProc` boots a port daemon as a child
PROCESS (``python -m repro_torch.core.protocol --device cpu``: these tests
run on the CPU) so ``kill9`` is an actual
SIGKILL — no atexit, no socket shutdown handshake, the TCP peer just
dies, exactly the failure the cluster tier must absorb.
:class:`FlakyProxy` sits between client and daemon as a plain TCP
forwarder with scripted misbehaviour — added latency (missed PING
deadlines) and connection drops (mid-pipeline resets) — so tests can
induce each failure mode deterministically and on cue.

Used by tests/test_torch_cluster_chaos.py.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class DaemonProc:
    """A daemon in a child process. ``addr``/``name`` once booted (the
    child prints ``SQLCACHED READY host port`` before serving);
    ``kill9`` SIGKILLs it — acknowledged state must survive on its
    replicas, nothing survives on it."""

    def __init__(self, boot_timeout: float = 60.0):
        env = dict(os.environ)
        env["PYTHONPATH"] = (os.path.join(_REPO, "src")
                             + os.pathsep + env.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.protocol",
             "--host", "127.0.0.1", "--port", "0", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env, cwd=_REPO)
        line = ""
        deadline = time.monotonic() + boot_timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if line.startswith("SQLCACHED READY"):
                break
            if not line and self.proc.poll() is not None:
                raise RuntimeError("daemon child exited before READY")
        else:
            self.kill9()
            raise RuntimeError(f"daemon did not boot in {boot_timeout}s")
        _, _, host, port = line.split()
        self.addr = (host, int(port))
        self.name = f"{host}:{int(port)}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill9(self) -> None:
        """SIGKILL — no shutdown path runs, connections drop mid-byte."""
        if self.alive:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)

    def __enter__(self) -> "DaemonProc":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.kill9()


def spawn_fleet(n: int) -> list[DaemonProc]:
    """Boot n daemon processes (serially: each prints READY when its
    loop is up, so the fleet is usable on return)."""
    fleet: list[DaemonProc] = []
    try:
        for _ in range(n):
            fleet.append(DaemonProc())
    except BaseException:
        for d in fleet:
            d.kill9()
        raise
    return fleet


class FlakyProxy:
    """TCP forwarder with scripted faults between a client and one
    daemon. ``latency`` delays every upstream-bound chunk (a slow node:
    TCP up, event loop effectively behind — PING deadlines catch it);
    ``drop_all()`` resets every live connection and refuses new ones
    until ``heal()`` (a network partition)."""

    def __init__(self, upstream: tuple[str, int]):
        self.upstream = upstream
        self.latency = 0.0
        self._dropped = False
        self._lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(32)
        self.addr = self._lsock.getsockname()
        self.name = f"{self.addr[0]}:{self.addr[1]}"
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()

    def drop_all(self) -> None:
        """Hard-reset every proxied connection and refuse new ones."""
        with self._lock:
            self._dropped = True
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             b"\x01\x00\x00\x00\x00\x00\x00\x00")
                s.close()
            except OSError:
                pass

    def heal(self) -> None:
        with self._lock:
            self._dropped = False

    def close(self) -> None:
        self.drop_all()
        try:
            self._lsock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ internals
    def _accept(self) -> None:
        while True:
            try:
                client, _ = self._lsock.accept()
            except OSError:
                return
            with self._lock:
                if self._dropped:
                    client.close()
                    continue
            try:
                up = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                client.close()
                continue
            with self._lock:
                self._conns += [client, up]
            threading.Thread(target=self._pump, args=(client, up, True),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(up, client, False),
                             daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              to_upstream: bool) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if to_upstream and self.latency:
                    time.sleep(self.latency)
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "FlakyProxy":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

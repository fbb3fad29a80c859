"""Boot an N-daemon SQLcached cluster of the port on this host.

    PYTHONPATH=src python -m repro_torch.launch.cluster_up [-n 3]
        [--host 127.0.0.1] [--ports 7001,7002,7003] [--device cuda]

Spawns N daemon processes (``python -m repro_torch.core.protocol``, each
on an OS-assigned port unless ``--ports`` pins them, each on ``--device``:
the CUDA card by default, ``cpu`` off the card), waits for every
``SQLCACHED READY host port`` line, then prints one line per node and a
ready-to-paste ``ClusterClient`` snippet. Runs in the foreground: Ctrl-C
(or SIGTERM) stops the fleet; ``kill -9 <pid>`` of one child is the way
to poke failover while a client runs. A child that exits before READY
stops the fleet with an error.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import signal
import subprocess
import sys
import time

SRC = pathlib.Path(__file__).resolve().parents[2]


def boot(host: str, port: int, device: str) -> tuple[subprocess.Popen, str]:
    """Start one daemon child and wait for its READY line; returns the
    process and its ``host:port``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.protocol",
         "--host", host, "--port", str(port), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=str(SRC.parent))
    while True:
        line = proc.stdout.readline()
        if line.startswith("SQLCACHED READY"):
            _, _, h, p = line.split()
            return proc, f"{h}:{int(p)}"
        if not line and proc.poll() is not None:
            raise RuntimeError(f"daemon on {host}:{port} ({device}) exited "
                               f"before READY (code {proc.returncode})")


def stop(fleet: list) -> None:
    """SIGTERM every child, then SIGKILL what is left after 5 s."""
    for proc, _ in fleet:
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + 5
    for proc, _ in fleet:
        try:
            proc.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=3, help="number of daemons")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--ports", default="",
                    help="comma-separated fixed ports (default: OS picks)")
    ap.add_argument("--device", default="cuda",
                    help="each daemon's device (default: the CUDA card)")
    args = ap.parse_args(argv)
    ports = ([int(p) for p in args.ports.split(",")] if args.ports
             else [0] * args.n)
    if len(ports) != args.n:
        ap.error(f"--ports needs exactly {args.n} entries")

    fleet: list[tuple[subprocess.Popen, str]] = []
    try:
        for port in ports:
            fleet.append(boot(args.host, port, args.device))
        names = [name for _, name in fleet]
        for proc, name in fleet:
            print(f"node {name}  pid {proc.pid}  device {args.device}")
        print()
        print("from repro_torch.core.cluster import ClusterClient")
        print(f"cc = ClusterClient({names!r})")
        print()
        print("Ctrl-C stops the fleet; kill -9 a pid to test failover.",
              flush=True)
        sigs = {signal.SIGINT, signal.SIGTERM}
        signal.pthread_sigmask(signal.SIG_BLOCK, sigs)
        signal.sigwait(sigs)
    except KeyboardInterrupt:
        pass
    finally:
        stop(fleet)
        print("cluster down")


if __name__ == "__main__":
    main()

"""The port's wire server against the reference's, byte for byte.

One raw socket script per test (the statement streams of
tests/test_protocol_pipeline.py: tagged pipelines, untagged statements,
errors mid-pipeline, bad ARGs, oversized lines) goes to a reference
``ThreadedServer`` over ``repro.core.SQLCached(mesh_exec=False,
warmup=False)`` and to the port's over ``SQLCached(device="cpu")``; the
response bytes must be identical. The port's own client talks to its
server too."""
import socket

import pytest

from repro.core.daemon import SQLCached as JDB
from repro.core.protocol import ThreadedServer as JServer
from repro_torch.core.daemon import SQLCached as TDB
from repro_torch.core.protocol import (_MAX_LINE, AsyncSQLCachedClient,
                                       SQLCachedClient, ThreadedServer,
                                       _encode_arg)


def frame(sql, args=(), tag=None):
    sfx = "" if tag is None else f"#{tag}"
    lines = [f"EXEC{sfx} {sql}"] + [_encode_arg(a) for a in args] + [f"GO{sfx}"]
    return ("\r\n".join(lines) + "\r\n").encode()


def exchange(addr, script: bytes) -> bytes:
    """Send the script plus a trailing PING; read until its PONG."""
    with socket.create_connection(addr, timeout=120) as s:
        s.sendall(script + b"PING\r\n")
        buf = b""
        while not buf.endswith(b"PONG\r\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return buf


def both(script: bytes):
    outs = []
    for server_cls, db in ((JServer, JDB(mesh_exec=False, warmup=False)),
                           (ThreadedServer, TDB(device="cpu"))):
        with server_cls(db=db) as srv:
            outs.append(exchange(srv.addr, script))
    assert outs[1] == outs[0]
    return outs[1].decode()


def test_pipeline_roundtrip_and_dml_counts():
    script = frame("CREATE TABLE p (a INT, b INT, s TEXT) CAPACITY 64")
    for i in range(10):
        script += frame("INSERT INTO p (a, b, s) VALUES (?, ?, ?)",
                        [i, i * 2, f"v{i}"], tag=f"i{i}")
    for i in range(10):
        script += frame("SELECT b, s FROM p WHERE a = ? LIMIT 1", [i],
                        tag=f"s{i}")
    script += frame("DELETE FROM p WHERE a = ?", [3], tag="d1")
    script += frame("DELETE FROM p WHERE a = ?", [3], tag="d2")
    script += frame("UPDATE p SET b = 9 WHERE a = ?", [0], tag="u1")
    script += frame("UPDATE p SET b = 9 WHERE a = ?", [77], tag="u2")
    script += frame("SELECT COUNT(*) FROM p")
    script += frame("SELECT SUM(b) FROM p WHERE a < ?", [5], tag="g")
    script += frame("SELECT * FROM p WHERE s = ?", ["v4"])
    script += frame("EXPLAIN SELECT b FROM p WHERE a = ?", tag="x")
    script += frame("EXPLAIN DELETE FROM p WHERE a = 1 OR b = 2")
    out = both(script)
    assert "ROW#s9 " in out and "COUNT#d2 0" in out


def test_errors_keep_order_and_sync():
    script = frame("CREATE TABLE e (a INT, b INT) CAPACITY 16")
    script += frame("INSERT INTO e (a, b) VALUES (?, ?)", [1, 2], tag="1")
    script += frame("SELECT a FROM no_such_table", tag="2")
    script += frame("SELECT COUNT(*) FROM e", tag="3")
    script += frame("SELECT a FROM", tag="4")           # parse error
    script += b"EXEC INSERT INTO e (a, b) VALUES (?, ?)\r\nARG I 1\r\n" \
              b"ARG Z 9\r\nGO\r\n"                        # bad ARG kind
    script += b"EXEC#5 INSERT INTO e (a, b) VALUES (?, ?)\r\n" \
              b"ARG Z bad\r\nARG I 5\r\nGO#5\r\n"
    script += b"ARG I 5\r\n"                              # ARG without EXEC
    script += frame("SELECT COUNT(*) FROM e", tag="6")
    out = both(script)
    assert "ERR#2 " in out and "ERR bad arg" in out


def test_oversized_lines_keep_sync():
    script = frame("CREATE TABLE lt (a INT) CAPACITY 16")
    script += frame("INSERT INTO lt (a) VALUES (?) -- " + "x" * (_MAX_LINE + 16),
                    [1], tag="1")
    script += frame("INSERT INTO lt (a) VALUES (?)", [2], tag="2")
    script += b"EXEC " + b"x" * (_MAX_LINE + 64) + b"\r\n"
    script += frame("SELECT COUNT(*) FROM lt")
    both(script)


def test_port_clients_on_port_server():
    with ThreadedServer(db=TDB(device="cpu")) as srv:
        c = SQLCachedClient(*srv.addr)
        c.execute("CREATE TABLE q (a INT, b INT) CAPACITY 64")
        with c.pipeline() as p:
            for i in range(6):
                p.execute("INSERT INTO q (a, b) VALUES (?, ?)", [i, i % 2])
        assert [r["count"] for r in p.results] == [1] * 6
        assert c.execute("SELECT COUNT(*) FROM q WHERE b = ?",
                         [1])["value"] == 3
        # WARMUP over the wire plans the canonical shapes: the reference's
        # count on the same table, then nothing new
        ddl = "CREATE TABLE w (a INT, b INT, INDEX(a)) CAPACITY 64"
        c.execute(ddl)
        ref = JDB(mesh_exec=False, warmup=False)
        ref.execute(ddl)
        want = ref.execute("WARMUP w").count
        assert want > 0
        assert c.execute("WARMUP w")["count"] == want
        assert c.execute("WARMUP w")["count"] == ref.execute(
            "WARMUP w").count == 0
        assert srv.server.scheduler.stats["max_group"] >= 2
        c.close()

        import asyncio

        async def main():
            ac = await AsyncSQLCachedClient.connect(*srv.addr)
            try:
                rs = await asyncio.gather(*[
                    ac.execute("SELECT b FROM q WHERE a = ? LIMIT 1", [i])
                    for i in range(6)])
                return [r["rows"][0]["b"] for r in rs]
            finally:
                await ac.close()

        assert asyncio.run(main()) == [i % 2 for i in range(6)]

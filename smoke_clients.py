#!/usr/bin/env python3
"""HTTP clients and a /healthz monitor for ``chip_smoke.py``'s phase 9, in
a process of their own, so that none of their threads takes the serving
process's GIL.  It imports no torch and nothing of the repo.

    python3 smoke_clients.py        # driven by chip_smoke.py over pipes

Protocol, one JSON object a line.  On stdin the parent sends:
  {"clock": true}        -> replies {"clock": time.perf_counter()}
  {"port", "t0", "clients": [{"at", "body", "cancel_after", "pause"}],
   "poll_s"}             -> starts every client at t0 + at (t0 on the
                            parent's ``perf_counter``: both read
                            CLOCK_MONOTONIC) and the monitor
  {"evicted": rid}       -> releases a paused client reading stream rid
  {"stop": true}         -> stops the monitor
It prints {"clients_done": true} once every client has ended, and at the
end {"clients": [...], "health": [...]}: per client its lines, their
receive times, the time it sent its POST and its error.

A client POSTs /v1/generate at its time and reads the NDJSON stream line
by line; with ``cancel_after`` it resets the connection after that token
index; with ``pause`` (a 1 KB receive buffer) it stops reading after
token 2 until the parent reports its stream evicted, then 0.3 s more.
"""
import http.client
import json
import socket
import struct
import sys
import threading
import time

DEADLINE_S = 240.0
PAUSE_WAIT_S = 60.0
PAUSE_EXTRA_S = 0.3


class Evictions:
    def __init__(self):
        self.rids = set()
        self.cond = threading.Condition()

    def add(self, rid):
        with self.cond:
            self.rids.add(rid)
            self.cond.notify_all()

    def wait(self, rid, timeout):
        with self.cond:
            self.cond.wait_for(lambda: rid in self.rids, timeout)
        time.sleep(PAUSE_EXTRA_S)


def run_client(port, t0, spec, rec, evictions):
    try:
        time.sleep(max(0.0, t0 + spec["at"] - time.perf_counter()))
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if spec.get("pause"):          # a small window fills up soon
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
        sock.settimeout(DEADLINE_S)
        sock.connect(("127.0.0.1", port))
        conn = http.client.HTTPConnection("127.0.0.1", port)
        conn.sock = sock
        rec["sent"] = time.perf_counter()
        conn.request("POST", "/v1/generate", body=json.dumps(spec["body"]))
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()}")
        while True:
            line = resp.readline()
            if not line:
                break
            rec["times"].append(time.perf_counter())
            ev = json.loads(line)
            rec["lines"].append(ev)
            if ev["type"] != "token":
                continue
            if ev["index"] == spec.get("cancel_after"):
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))   # a reset
                sock.close()
                return
            if ev["index"] == 2 and spec.get("pause"):
                evictions.wait(ev["rid"], PAUSE_WAIT_S)
        conn.close()
    except Exception as e:  # noqa: BLE001 — reported to the parent
        rec["error"] = repr(e)


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return [resp.status, json.loads(resp.read())]
    finally:
        conn.close()


def monitor(port, poll_s, stop, health):
    while not stop.is_set():
        try:
            health.append(get(port, "/healthz"))
        except Exception as e:  # noqa: BLE001
            health.append([0, repr(e)])
        time.sleep(poll_s)


def emit(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main():
    evictions, stop = Evictions(), threading.Event()
    health, recs, threads, mon = [], [], [], None

    def wait_clients():
        for t in threads:
            t.join()
        emit({"clients_done": True})

    for line in sys.stdin:
        msg = json.loads(line)
        if "clock" in msg:
            emit({"clock": time.perf_counter()})
        elif "clients" in msg:
            port, t0 = msg["port"], msg["t0"]
            mon = threading.Thread(target=monitor, daemon=True, args=(
                port, msg["poll_s"], stop, health))
            mon.start()
            for spec in msg["clients"]:
                recs.append({"lines": [], "times": [], "sent": None,
                             "error": None})
                threads.append(threading.Thread(
                    target=run_client, daemon=True,
                    args=(port, t0, spec, recs[-1], evictions)))
            for t in threads:
                t.start()
            threading.Thread(target=wait_clients, daemon=True).start()
        elif "evicted" in msg:
            evictions.add(msg["evicted"])
        elif "stop" in msg:
            stop.set()
            if mon is not None:
                mon.join(5.0)
            break
    emit({"clients": recs, "health": health})
    return 0


if __name__ == "__main__":
    sys.exit(main())

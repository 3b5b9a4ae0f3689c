"""The benchmark's callers, in a process of their own so that their host
time does not compete with the server's threads for the interpreter lock.

    python -m benchmark.client

It reads the plan, one JSON line on stdin: ``url``, ``endpoint``,
``kind`` (a module of ``benchmark/traffic``), ``schedule``, ``bodies``
(the request bodies, in order), ``t0`` (``time.monotonic()`` of the
window's start; the clock is the machine's, shared with the harness) and
``seconds``. Once every request is answered, it writes one JSON line:
``records``, one per request made, ``{"i", "due", "sent", "done",
"status", "samples", "error"}`` with times on the same clock, and
``started``, when it began. It then reads a JSON list of request indices
and writes their answers, ``{i: base64 int16 PCM}``, as a last line.
Imports the standard library only.
"""

import base64
import http.client
import json
import sys
import threading
import time
import urllib.parse

from benchmark.traffic import kind

WAV_HEADER = 44
TIMEOUT_S = 120.0


def _pcm(resp):
    """The PCM bytes of a 200 answer."""
    body = resp.read()
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise ValueError("answer is not a WAV")
    return body[WAV_HEADER:]


class Pool:
    """Idle keep-alive connections to the server, shared by the senders: a
    request takes one (or opens one when none is idle) and gives it back
    once its answer is read, as an HTTP client library's pool does. A
    closed loop's callers so keep one connection each."""

    def __init__(self, host, port):
        self.host, self.port = host, port
        self.idle = []
        self.lock = threading.Lock()

    def take(self):
        with self.lock:
            if self.idle:
                return self.idle.pop()
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=TIMEOUT_S)

    def give(self, conn):
        with self.lock:
            self.idle.append(conn)

    def close(self):
        with self.lock:
            for conn in self.idle:
                conn.close()
            self.idle = []


def main():
    started = time.monotonic()
    plan = json.loads(sys.stdin.readline())
    url = urllib.parse.urlsplit(plan["url"])
    bodies = plan["bodies"]
    records, answers = [], {}
    lock = threading.Lock()
    pool = Pool(url.hostname, url.port)
    # connections the traffic keeps, opened one at a time before the
    # window: a burst of them would overflow the server's accept backlog
    for conn in [pool.take()
                 for _ in range(plan["schedule"].get("connections", 0))]:
        conn.connect()
        pool.give(conn)

    def send(i, due):
        rec = {"i": i, "due": due, "sent": time.monotonic(), "done": None,
               "status": None, "samples": 0, "error": None}
        pcm = None
        conn = pool.take()
        try:
            conn.request("POST", plan["endpoint"], json.dumps(bodies[i]),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            rec["status"] = resp.status
            if resp.status == 200:
                pcm = _pcm(resp)
                rec["samples"] = len(pcm) // 2
            else:
                rec["error"] = resp.read()[:200].decode("utf-8", "replace")
            if resp.will_close:
                conn.close()
            else:
                pool.give(conn)
        except Exception as e:          # noqa: BLE001 - a failed request
            rec["error"] = repr(e)[:200]
            conn.close()
        rec["done"] = time.monotonic()
        with lock:
            records.append(rec)
            if pcm is not None:
                answers[i] = pcm

    kind(plan["kind"]).drive(plan["schedule"], send, plan["t0"],
                             plan["seconds"])
    pool.close()
    print(json.dumps({"records": records, "started": started}), flush=True)
    wanted = json.loads(sys.stdin.readline())
    print(json.dumps({i: base64.b64encode(answers[i]).decode()
                      for i in wanted if i in answers}), flush=True)


if __name__ == "__main__":
    main()

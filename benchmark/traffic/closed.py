"""Closed loop: ``clients`` callers, each sending its next request as soon
as its last one is answered, from the window's start to its end. Caller
``c`` takes requests c, c + clients, c + 2 clients, ... of the cell's
request list, so a seed fixes what each caller sends."""

import threading
import time


def schedule(params, seed, seconds):
    clients = int(params["clients"])
    # more than any caller can send in the window: one request a caller
    # every 20 ms
    return {"clients": clients, "connections": clients,
            "n_requests": clients * (int(seconds * 50) + 2)}


def drive(plan, send, t0, seconds):
    end = t0 + seconds
    clients = plan["clients"]

    def caller(c):
        i = c
        while i < plan["n_requests"]:
            now = time.monotonic()
            if now >= end:
                return
            if now < t0:
                time.sleep(t0 - now)
            send(i, max(t0, time.monotonic()))
            i += clients

    threads = [threading.Thread(target=caller, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

"""HTTP load generator for the front-door throughput test, run as a
process of its own so that its client threads do not share an
interpreter lock with the server they measure.

    python tests/_torch_http_load.py <url> <clients> <obs.npy> <out.json>

Posts ``{"obs": row}`` for every row of ``obs.npy`` (8 warm requests
first), ``clients`` threads at a time, each on a new connection, and
writes ``{"rps": ..., "results": [...]}`` (a ``{"result": ...}``
answer unwrapped)."""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request

import numpy as np


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120.0) as resp:
        return json.loads(resp.read())


def main(url, clients, obs_path, out_path):
    obs = np.load(obs_path)
    for o in obs[:8]:
        _post(url, {"obs": o.tolist()})
    results = [None] * len(obs)
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                if i >= len(obs):
                    return
                next_i[0] += 1
            out = _post(url, {"obs": obs[i].tolist()})
            results[i] = out.get("result", out)

    threads = [threading.Thread(target=worker) for _ in range(int(clients))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rps = len(obs) / (time.perf_counter() - t0)
    with open(out_path, "w") as f:
        json.dump({"rps": rps, "results": results}, f)


if __name__ == "__main__":
    main(*sys.argv[1:5])

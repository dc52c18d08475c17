"""Load-test the port's serving daemon (counterpart of scripts/serve_load.py).

Fires concurrent /enhance requests from a directory of 16 kHz wavs against a
running `python -m storm_tpu_torch.serve` and reports the aggregate serving
throughput, latency percentiles and the server's own batching counters over
this run, with the server's configuration from /healthz. The throughput is
comparable to `python -m storm_tpu_torch.bench`'s audio s/s at the same
configuration, plus the HTTP and dynamic-batching overhead. Closed loop:
`--concurrency` clients, each sending its next request when the last one
has been answered. urllib only.

    python -m storm_tpu_torch.serve --ckpt <c> --mode storm --warmup_s 4 &
    python -m storm_tpu_torch.serve_load --url http://127.0.0.1:8571 \\
        --dir noisy/ --requests 64 --concurrency 16

Prints one JSON line (and writes it to `--json` if given).
"""
from __future__ import annotations

import argparse
import glob
import http.client
import json
import os
import threading
import time
import urllib.request
from typing import Optional, Sequence

PCM16_HEADER_BYTES = 44  # the server's replies are 16-bit PCM WAVs with a plain header


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="http://127.0.0.1:8571")
    ap.add_argument("--dir", required=True, help="directory of 16 kHz wavs")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--json", default=None, help="write the report here")
    return ap.parse_args(argv)


def _post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url + "/enhance", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=3600) as r:
        return r.read()


def _get_json(url: str, path: str) -> dict:
    """The server's JSON at `path`, or {} once the server has gone (a drain)."""
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return json.loads(r.read())
    except (OSError, http.client.HTTPException):
        return {}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.dir, "*.wav")))
    if not files:
        raise SystemExit(f"no wavs in {args.dir}")
    payloads = []
    for i in range(args.requests):
        with open(files[i % len(files)], "rb") as f:
            payloads.append(f.read())

    # one request first, so that first-call costs stay out of the measurement
    _post(args.url, payloads[0])
    stats0 = _get_json(args.url, "/stats")
    if not stats0:
        raise SystemExit(f"no /stats at {args.url}")

    lat, lock = [], threading.Lock()
    audio_bytes, errors, idx = [0], [0], [0]

    def worker():
        while True:
            with lock:
                if idx[0] >= len(payloads):
                    return
                body = payloads[idx[0]]
                idx[0] += 1
            t0 = time.perf_counter()
            try:
                out = _post(args.url, body)
            except (OSError, http.client.HTTPException):
                # a draining server refuses new connections: count it and
                # report the requests that did complete
                with lock:
                    errors[0] += 1
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                audio_bytes[0] += len(out) - PCM16_HEADER_BYTES

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    stats1 = _get_json(args.url, "/stats") or dict(stats0)
    health = _get_json(args.url, "/healthz")
    health.pop("status", None)
    if not lat:
        raise SystemExit("no request completed; nothing to report")
    lat.sort()
    audio_s = audio_bytes[0] / 2 / 16000
    n_batches = stats1["batches"] - stats0["batches"]
    row_slots = stats1["row_slots"] - stats0["row_slots"]
    batched = stats1["batched_requests"] - stats0["batched_requests"]
    report = {
        "requests": len(lat),
        "errors": errors[0],
        "concurrency": args.concurrency,
        "wall_s": round(wall, 3),
        "audio_s": round(audio_s, 2),
        "audio_s_per_s": round(audio_s / wall, 3),
        "latency_p50_s": round(lat[len(lat) // 2], 3),
        "latency_p95_s": round(lat[int(len(lat) * 0.95)], 3),
        "server_batches": n_batches,
        "mean_batch": round(batched / max(1, n_batches), 2),
        # the share of dispatched rows that carried a request (the rest is
        # row padding), over this run only
        "batch_fill": round(batched / row_slots, 4) if row_slots else None,
        # the server's own configuration, so that the report names what it measured
        "server_config": health,
    }
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

"""Online enhancement server: HTTP front end over the dynamic batcher
(counterpart of serve.py), for `--mode storm`, `score-only`, `denoiser-only`
and `distill`.

    python -m storm_tpu_torch.serve --ckpt model.pt --mode storm --port 8571 \\
        [--batch 8] [--warmup_buckets 1,2.5,4] [--quant int8 --calib_dir noisy/] \\
        [--deepcache 3]
    curl -s --data-binary @noisy.wav localhost:8571/enhance > clean.wav

Endpoints:
    POST /enhance   16 kHz WAV in, enhanced WAV out (X-NFE and X-RTF headers;
                    X-NFE is 1 for the denoiser-only model's one forward, 2 for
                    the distilled student's)
    GET  /healthz   readiness and the serving configuration (mode, torch device, card)
    GET  /stats     request and batch counters, audio seconds served, batch fill,
                    and under "graphs" the captured programs' counters

Sampler flags and defaults are the enhancement CLI's, with the samplers
that enqueue without a device sync: `--sampler pc` or `ode` with the six
fixed-step methods of `--ode-method` (not rk45, nor picard); warm-up runs
the mode and sampler served. The denoiser-only and distilled models ignore
the sampler flags; the distilled one refuses `--deepcache`. The NCSN++ compute
dtype defaults to bfloat16, as the reference serves (`--dtype float32`, or
`checkpoint` for the checkpoint config's); /healthz reports the dtype
served. Noise comes
from one torch.Generator seeded with `--seed`, owned by the batcher's
dispatcher thread; int8 calibration draws from its own, seeded `--seed` + 1.
SIGTERM stops accepting requests and drains the queue.

On a card every batch is the replay of the captured CUDA graph of its row
count and bucket (`utils/graphs.py`): `--warmup_s` / `--warmup_buckets`
capture every row size at every warmed bucket before the server accepts
requests, as the reference compiles them; a shape not warmed runs the
eager loop at its first batch and is captured at its second. /stats
"graphs": first calls, captures, replays, eager calls, capture seconds, the
graph pool's bytes and the static buffers'; /healthz "execution": "graph".
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from .ckpt import load_checkpoint
from .data.audio import load_wav
from .models.base import check_deepcache_config
from .models.distill import refuse_deepcache
from .models.factory import SERVING_MODES, build_model, check_checkpoint_mode
from .sampling.correctors import CORRECTORS
from .sampling.predictors import PREDICTORS
from .sampling.samplers import ODE_METHODS
from .utils.inference import BucketedEnhancer
from .utils.server import DynamicBatcher, _default_row_sizes, decode_wav_bytes, encode_wav_bytes
from .utils.serving import calibrate_or_load_scales

MODEL_SR = 16000


class _Server(ThreadingHTTPServer):
    # a deep listen backlog: bursts of clients are what a batching server expects
    request_queue_size = 128
    daemon_threads = True


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="Checkpoint file (.pt, storm_tpu_torch.ckpt).")
    p.add_argument("--mode", required=True, choices=SERVING_MODES,
                   help="storm, score-only (SGMSE+), denoiser-only or distill (the one-step "
                        "student)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--batch", type=int, default=8, help="largest dynamic batch")
    p.add_argument("--max_wait_ms", type=float, default=100.0,
                   help="linger: longest queueing wait before a partial batch leaves")
    p.add_argument("--warmup_s", type=float, default=0.0,
                   help="before serving, run every row size at the bucket of this many "
                        "seconds (0: none)")
    p.add_argument("--warmup_buckets", default=None,
                   help="comma-separated lengths in seconds to warm as well; a batch is "
                        "padded to its largest bucket, so warm the buckets traffic spans")
    p.add_argument("--row_sizes", default=None,
                   help="comma-separated allowed batch row counts (default 1,2,4,...,--batch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", choices=("pc", "ode"), default="pc")
    p.add_argument("--predictor", default="reverse_diffusion", choices=tuple(PREDICTORS))
    p.add_argument("--corrector", default="ald", choices=tuple(CORRECTORS))
    p.add_argument("--corrector-steps", dest="corrector_steps", type=int, default=1)
    p.add_argument("--snr", type=float, default=0.5)
    p.add_argument("--N", type=int, default=50)
    p.add_argument("--ode-method", dest="ode_method", default="etd2",
                   choices=tuple(m for m in ODE_METHODS if m != "rk45"))
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=("checkpoint", "float32", "bfloat16"),
                   help="NCSN++ compute dtype; bfloat16 (the default) is the reference's "
                        "production serving program, 'checkpoint' keeps the checkpoint "
                        "config's dtype; parameters stay float32")
    p.add_argument("--quant", default=None, choices=("int8",))
    p.add_argument("--quant_min_channels", type=int, default=128)
    p.add_argument("--calib_dir", default=None,
                   help="representative noisy wavs for int8 calibration (needed with "
                        "--quant int8 unless the scales are cached beside the checkpoint)")
    p.add_argument("--deepcache", type=int, default=0,
                   help="deep-feature cache refresh interval (the enhancement CLI's "
                        "--deepcache); 0 = the exact trajectory")
    p.add_argument("--deepcache_depth", type=int, default=1,
                   help="top U-Net levels recomputed per cached score eval")
    p.add_argument("--data_parallel", action="store_true", help="not ported yet (ROADMAP R7)")
    p.add_argument("--seq_parallel", type=int, default=0, help="not ported yet (ROADMAP R7)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def make_handler(batcher: DynamicBatcher, info: dict, model_sr: int = MODEL_SR):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # no access log
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **info})
            elif self.path == "/stats":
                with batcher._lock:
                    s = dict(batcher.stats)
                audio_s = s.pop("audio_samples") / model_sr
                s["audio_s"] = round(audio_s, 3)
                s["rtf"] = round(s["device_s"] / audio_s, 4) if audio_s else None
                s["batch_fill"] = (round(s["batched_requests"] / s["row_slots"], 4)
                                   if s["row_slots"] else None)
                s["graphs"] = getattr(batcher.enhancer, "graph_stats", None)
                self._json(200, s)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/enhance":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                y, sr = decode_wav_bytes(body)
            except Exception as e:  # any malformed payload is the client's
                self._json(400, {"error": f"not a WAV payload: {e}"})
                return
            if sr != model_sr:
                self._json(400, {"error": f"sample rate {sr} != {model_sr}; resample to 16 kHz"})
                return
            y = y[0]
            t0 = time.perf_counter()
            try:
                x_hat, nfe = batcher.submit(y)
            except Exception as e:  # the enhancer's failure, reported to this client
                self._json(500, {"error": str(e)})
                return
            elapsed = time.perf_counter() - t0
            wav = encode_wav_bytes(x_hat, model_sr)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.send_header("X-NFE", str(nfe))
            self.send_header("X-RTF", f"{elapsed / (y.shape[-1] / model_sr):.4f}")
            self.end_headers()
            self.wfile.write(wav)

    return Handler


def build_server(args):
    """Load the model, calibrate or load int8 scales, warm the buckets, and
    return (the HTTP server, bound but not serving, and its DynamicBatcher)."""
    device = torch.device(args.device)
    config, params, ema_params = load_checkpoint(args.ckpt)
    check_checkpoint_mode(args.mode, config)
    config = dict(config)
    if args.dtype != "checkpoint":
        # a program property: the parameters stay as stored, float32
        config["dtype"] = args.dtype
    model = build_model(config, device=device)
    model.load_state_dict(params if args.no_ema else ema_params, strict=True)
    if args.mode == "distill":  # NFE 2: no trajectory to cache along
        refuse_deepcache(args.deepcache)
    elif args.deepcache and args.mode != "denoiser-only":  # one forward: nothing to cache
        check_deepcache_config(model.score_net if args.mode == "storm" else model.dnn,
                               args.deepcache, args.sampler, args.deepcache_depth,
                               args.ode_method)

    quant = None
    if args.quant == "int8":
        def calib():
            files = sorted(glob.glob(os.path.join(args.calib_dir or "", "*.wav")))[:4]
            if not files:
                raise SystemExit("--quant int8 needs --calib_dir with wavs (or scales cached "
                                 "beside the checkpoint)")
            return [load_wav(f)[0][0] for f in files]

        quant = calibrate_or_load_scales(
            model, args.mode, args.ckpt, calib,
            torch.Generator(device=device).manual_seed(args.seed + 1), N=args.N,
            min_channels=args.quant_min_channels,
            params_source="raw" if args.no_ema else "ema", model_sr=MODEL_SR)

    enhancer = BucketedEnhancer(
        model, data_parallel=args.data_parallel, seq_parallel=args.seq_parallel,
        N=args.N, sampler_type=args.sampler, predictor=args.predictor,
        corrector=args.corrector, corrector_steps=args.corrector_steps, snr=args.snr,
        method=args.ode_method, quant=quant, deepcache=args.deepcache,
        deepcache_depth=args.deepcache_depth)
    if args.row_sizes:
        row_sizes = sorted({int(r) for r in args.row_sizes.split(",")})
        if row_sizes[0] < 1 or row_sizes[-1] > args.batch:
            raise SystemExit(f"--row_sizes must lie in [1, {args.batch}]")
        if row_sizes[-1] != args.batch:
            row_sizes.append(args.batch)  # a full batch must be dispatchable
    else:
        row_sizes = _default_row_sizes(args.batch)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    warmup_s = [args.warmup_s] if args.warmup_s > 0 else []
    if args.warmup_buckets:
        warmup_s += [float(s) for s in args.warmup_buckets.split(",")]
    # every row size at every warmed bucket, so that traffic there meets no
    # first-call cost: each warm-up call runs the eager loop and captures its
    # graph (the kernels build here too)
    lens = sorted({enhancer.padded_len(int(s * MODEL_SR)) for s in warmup_s})
    shapes = [(rows, T) for T in lens for rows in row_sizes]
    for done, (rows, T) in enumerate(shapes, 1):
        enhancer.warm_up(np.zeros((rows, T), np.float32), generator)
        print(f"warmup {done}/{len(shapes)}: rows={rows} bucket={T / MODEL_SR:.3f}s", flush=True)

    batcher = DynamicBatcher(enhancer, generator, max_batch=args.batch,
                             max_wait_ms=args.max_wait_ms, row_sizes=row_sizes)
    info = {
        "mode": args.mode, "sampler": args.sampler, "N": args.N,
        "quant": args.quant or "none", "deepcache": args.deepcache,
        "deepcache_depth": args.deepcache_depth, "batch": args.batch,
        "device": str(enhancer.device),
        "device_name": (torch.cuda.get_device_name(enhancer.device)
                        if enhancer.device.type == "cuda" else "cpu"),
        "predictor": args.predictor, "corrector": args.corrector,
        "corrector_steps": args.corrector_steps, "snr": args.snr,
        "ode_method": args.ode_method if args.sampler == "ode" else None,
        "row_sizes": row_sizes, "max_wait_ms": args.max_wait_ms,
        "warmup_buckets_s": [T / MODEL_SR for T in lens],
        "backbone": "ncsnpp", "dtype": config.get("dtype", "float32"), "seed": args.seed,
        "execution": enhancer.execution,
        "ckpt": os.path.abspath(args.ckpt),
    }
    try:
        httpd = _Server((args.host, args.port), make_handler(batcher, info))
    except OSError:
        batcher.close()
        raise
    return httpd, batcher


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_argparser().parse_args(argv)
    httpd, batcher = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /enhance)", flush=True)

    # orchestrators stop containers with SIGTERM: stop accepting, then drain
    # the queued batches in close() instead of dying mid-request
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=httpd.shutdown, daemon=True).start())
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
        print("drained; bye", flush=True)


if __name__ == "__main__":
    main()

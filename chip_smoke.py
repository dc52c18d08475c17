"""Smoke run of the PyTorch port (storm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --train_worker OUT -- <train flags>   (phase 71's worker)

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off.
2. build: every CUDA source of the port with nvcc (sm_90a), timed.
3. kernel against plain: upfirdn2d at every shape the full-width main path
   gives it (4 s request: 256 bins x 576 frames, B=1: the wave padded to its
   bucket of 64 hops, 65536 samples, 513 frames padded to 576), with the NCSN++ FIR and
   with an asymmetric one, held to atol = rtol = 1e-5 against the plain
   PyTorch version; kernel, plain and library-call times (CUDA events, back to
   back: a small call shows the host's enqueue cost) and the kernel's device
   time (`device_ms`, from profiler kernel events, each call after a read
   that clears the L2) beside the memory bound, and one line of their sums
   over the 18 calls of a score forward (the kernel's row per forward).
   The same check, untimed, at the widths of the shorter files (192 and 384
   frames).
4. full-width NCSN++: one 27.8M score-net forward through the kernel and
   through the plain version, same weights, held to 1e-4 of the output scale.
5. main path: the full-width StoRM model (2 x 27.8M, seeded random weights)
   saved as a checkpoint and run through `python -m storm_tpu_torch.enhancement`
   (CLI defaults: pc, reverse_diffusion, ald, N=50) on three synthesized 16 kHz
   files of 1, 2.5 and 4 s; outputs must be finite and as long as the inputs,
   and upfirdn2d must have launched 18 times per NCSN++ forward.

6. (with `--profile`) one enhancement of the 4 s file traced with
   torch.profiler: the device time by kernel and the device's busy share.
7. kernels against plain at a train step's shapes (B=8, 256 bins x 256
   frames, which validation shares): the forward output at every forward
   shape, and the gradient at every backward shape from
   `torch.autograd.grad` through the kernel path (forward and backward
   kernels) against PyTorch's autograd of the plain version, NCSN++ and
   asymmetric FIRs, atol = rtol = 1e-5; backward kernel (event and device
   time), plain backward and library-call times beside the memory bound.
8. training: (a) one full-width step's gradients (B=2, same weights, t, z
   and batch) through the kernels against the plain path, with cuDNN
   deterministic; (b) `python -m storm_tpu_torch.train` for 4 steps at B=8
   on a synthesized wsj0-layout corpus: finite losses, parameters and EMA
   moved, `last.pt` and `best_loss.pt` written, exactly 36 forward and 33
   backward upfirdn2d launches per step; the trainer's step runs as the
   replay of its captured program from the third step (utils/
   train_graphs.py; the first eager, the second the warm-up and capture),
   the validation batch's from the third epoch; ms per step (CUDA events
   around `TrainPrograms.step`, no sync added to the trainer's loop: the
   median period of the replayed steps), audio seconds trained per second,
   peak allocated and reserved memory (the program's pool included), the
   capture's seconds; (c) the written checkpoint enhances one file
   through `python -m storm_tpu_torch.enhancement` at N=2.
9. (with `--profile`) two full-width train steps traced with torch.profiler.
10. int8 quantizer (K3) against plain: activation scales calibrated on the
   4 s file, then the input of every quantized conv of one denoiser and one
   score forward at the 4 s request's width (110 calls, f32), with exact .5
   ties and values beyond +-127 written in; the codes must be identical.
   Kernel (event and device time) and plain times per input shape beside the
   memory bound (5 B per element). The same at the probe's shape, (16*256*256, 128) bf16, s = 12.7
   (3 B per element), and with bf16 ties at s = 2. The record's error is
   the largest |kernel code - plain code| over all these inputs.
11. int8 main path: `python -m storm_tpu_torch.enhancement --quant int8` on
   phase 5's checkpoint and files: the first run calibrates and writes the
   scale cache, the second loads it; outputs finite and as long as the
   inputs; per file exactly 55 + 55 x 2N quantizer launches and 18
   upfirdn2d launches per forward (calibration runs with quantization off:
   no quantizer launch, 18 per calibration forward). Then, with cuDNN
   deterministic and the same noise at N=4, the 4 s
   file's int8 output through the kernel against the same path with the
   plain quantizer (<= 1e-6 of the output's scale), and each file's int8
   output against float32; RTF int8 against float32 (phase 5).
12. fused_leaky_relu (K2) through its op API at (8, 256, 256, 128) and
   (3, 17, 33, 6): forward against the plain version at atol = rtol = 1e-6,
   and both gradients (torch.autograd.grad) equal to autograd of the plain
   version's, bit for bit; kernel (event and device time) and plain times
   beside the memory bound (8 B per element).
13. (with `--profile`) one int8 enhancement of the 4 s file traced.
14. batched CLI: `python -m storm_tpu_torch.enhancement --batch 4 --timeit
   --N 4` on 8 files of 1.0-4.0 s, two length buckets of
   4: outputs finite and as long as the inputs, exactly 18 x 9 upfirdn2d launches per
   batch call; upfirdn2d against plain at every shape the batches gave it;
   one batch with injected noise against each of its rows enhanced alone with
   that row's noise (N=5, 1e-4 of the row's scale).
15. HTTP server: `storm_tpu_torch.serve --dtype float32` built in this process
   (port 0, --batch 4, --N 3, the 4 s bucket warmed at every row size);
   12 requests of
   1-4 s from 8 client threads: every reply 200, a finite WAV of the input's
   length, X-NFE = 7; /stats: 12 requests, 0 errors, a batch of more than one
   row; exactly 18 x 7 upfirdn2d launches per warm-up call and batch. Then
   with --quant int8 --calib_dir on 8 requests: 55 x 7 quantizer launches per
   warm-up call and batch (calibration launches none). Prints throughput
   (audio s per wall s), latency p50 / p95 / max (over 12 requests the p95
   lies between the two slowest: smoke readings, not a serving baseline),
   batch fill and device_s; both kernels against plain at every shape the
   server gave them.
16. streaming: `--stream_chunk_s 2.0 --stream_overlap_s 0.5 --N 3` on one 12 s
   file, f32 then int8 (the scale cache records stream_chunk_s 2.0): output
   finite and as long as the input, 18 x 7 upfirdn2d launches per call of 8
   chunks (B=8, 256 x 320) and, int8, 55 x 7 quantizer launches per call;
   upfirdn2d against plain at every shape both runs gave it, the quantizer's
   codes at every input shape the int8 run gave it.
17. (with `--profile`) one B=4 enhancement at the 4 s bucket traced.
18. bfloat16 kernels: upfirdn2d at every main-path shape (B=1, 576 frames)
   against plain, within 1 ulp of each element (NCSN++'s FIR: equal; an
   asymmetric FIR's inexact products add their float32 rounding), the
   elements that differ counted; kernel (event and L2-cold device time),
   plain and bf16 library-call times beside the 2 B-per-element bound, and
   their sums per score forward on one line. The adjoint's bf16 instance at
   every train-step backward shape. GroupNorm on
   bf16 with float32 scale and bias against float32 GroupNorm rounded once.
   One full-width NCSN++ forward in bf16 through the kernel and the plain
   version, and its time against float32's.
19. `python -m storm_tpu_torch.enhancement --dtype bfloat16` at the CLI
   defaults on phase 5's three files, with `--batch 4 --N 4` on phase 14's
   eight, and with `--quant int8`: exact launch counts (18 upfirdn2d and, int8, 55
   quantizer launches per forward), every launch in bf16, RTF, and
   max|bf16 - f32| / max|f32| against the float32 runs on the same files
   and seed; upfirdn2d against plain at every shape the runs gave it.
20. the quantizer's bf16-product mode at every quantized-conv input of one
   int8 bf16 forward of each net (110 calls), ties of the bf16 product
   written in: codes identical to plain; per-shape times for the score net;
   and at every input shape of phase 19's int8 run.
21. the HTTP server at its default dtype, bfloat16, then int8 + bf16, on
   phase 15's burst: replies, launch counts, /healthz's dtype, both kernels
   against plain at every shape the servers gave them.
22. streaming in bf16 on phase 16's file: launch counts, K1 at its shapes.
23. (with `--profile`) one bf16 enhancement of the 4 s file traced: the
   shares of convolutions, layout transforms, GroupNorm statistics,
   elementwise kernels and K1.
24. bfloat16 training's kernels: upfirdn2d in bf16 at every train-step
   shape (B=8, 256 x 256) through `UpFirDn2d`, forward and gradient against
   autograd of the plain version, both FIRs, within 1 ulp of each element
   plus the float32 sum's rounding (the elements that differ counted with
   phase 18's); the backward kernel timed (event and L2-cold device time)
   beside the plain backward, the bf16 adjoint library call and the 2
   B-per-element bound, and their sums per step (33 calls) on one line. One
   full-width bf16 step's gradients (B=2, cuDNN
   deterministic): 36 + 33 launches, all bf16; the L2 distance from the
   plain path's at most 0.1, and from the float32 step's at least 0.5, of
   the plain path's bf16-against-f32 distance. One B=8 bf16 step timed and
   its peak memory read with the port's GroupNorm (`LowPrecisionGroupNorm`,
   which keeps x in bf16 for its backward) and with the same arithmetic
   left to autograd (which keeps a float32 copy: the bytes counted); the
   port's must peak lower.
25. `python -m storm_tpu_torch.train --dtype bfloat16 --num_eval_files 4`
   on phase 8's corpus, 12 steps (three epochs) at B=8, `--eval_N 4`: the
   checks of phase 8 (exactly 36 + 33 upfirdn2d launches per step, all
   bf16; the third epoch's evaluation replays the graph the second
   captured, with that epoch's EMA weights), with the in-training
   evaluation's launches (18 per forward) in the count;
   finite ValidationSISDR and ValidationESTOI, ValidationPESQ NaN unless
   `pesq` imports; `best_pesq.pt` written, its meta naming the metric; the
   config's dtype bfloat16; that checkpoint enhances one file in bf16
   through `--dtype checkpoint`. Step period, audio s/s and peak memory
   beside phase 8's float32 figures.
26. the float32 trainer with the evaluation (`--num_eval_files 4 --eval_N
   4`), one epoch of 4 steps: the same checks.
27. fused_leaky_relu (K2) in bf16 through its op API at phase 12's shapes:
   forward equal to plain; input gradient within 1 ulp of each element,
   bias gradient within 1 ulp of its scale, of autograd of plain; timed
   beside the 4 B-per-element bound.
28. (with `--profile`) two full-width bf16 train steps traced, with phase
   23's groups.
29. deep-feature caching: one full-width score net at the 4 s bucket, in
   float32 and bf16, each with and without phase 19's int8 scales:
   forward_shallow(deep_features(x)) against forward(x) (<= 1e-6 of the
   output's scale: the same operations on the same shapes), the cache in the
   compute dtype, each pass's upfirdn2d and quantizer launches equal to the
   counts read from the module list (depth 1: 18 / 17 / 1 and 55 / 49 / 8
   for the full, deep and shallow passes), and the passes' times.
30. `python -m storm_tpu_torch.enhancement --deepcache 3` on phase 5's three
   files at the CLI defaults in float32, bf16 and `--quant int8 --dtype
   bfloat16` (phase 19's scales, loaded): per file exactly 18 + 17 x 17 +
   100 x 1 = 407 upfirdn2d launches (1818 exact) and, int8, 55 + 17 x 49 +
   100 x 8 = 1688 quantizer launches (5555 exact), derived from the module
   list; every K1 shape and K3 input the runs gave against plain; the RTF
   and max|dc3 - exact| / max|exact| against the exact runs of phases 5 and
   19 on the same files and seed.
31. the HTTP server with `--deepcache 3` on phase 15's burst, bf16 (its
   default) then int8 + bf16: /healthz reports deepcache and its depth,
   exact launch counts per warm-up call and batch, both kernels against
   plain at every shape the servers gave them. Then `python -m
   storm_tpu_torch.serve_load` against a bf16 dc3 server of --batch 8: 48
   requests of phase 15's files from 16 closed-loop clients, its report
   (audio s per wall s, latency p50 and p95, batch fill), no error, exact
   launch counts, K1 against plain at every shape it gave it (rows up to 8).
32. `python -m storm_tpu_torch.bench` at bench.py's defaults (B=16, 256
   frames, ald, bf16, int8, dc3) but N=5; 1 timed rep here, the extras' budget
   at 0 s: the headline line alone), then `--train` (the eager step, then
   the replayed one: its line's value and `step_ms`, beside
   `eager_step_ms`): their JSON lines; the serving run's launches held to
   those of its calls (calibration, the headline), the train run's
   to 36 + 33 per step; K1 and K3 against plain at the shapes they gave,
   and K1's adjoint at every B=16 shape the train run's backward gave it.
33. (with `--profile`) one dc3 bf16 enhancement of the 4 s file traced.
34. (with `--profile`) one call at bench.py's defaults traced (B=16, 256
   frames, N=50 + ald, bf16, dc3), with int8 and without.
35. `python -m storm_tpu_torch.enhancement --sampler ode` on phase 5's three
   files with etd2, the CLI's ODE default, at N=4 (1 + 2 x 4 + 1 = 10
   forwards per file) in float32, bf16 and `--quant int8 --dtype bfloat16`
   (phase 19's scales, loaded): outputs finite and as long as the inputs,
   per file exactly 18 x 10 upfirdn2d and, int8, 55 x 10 quantizer
   launches; the RTF beside pc's (phases 5 and 19); every K1 shape and K3
   input against plain. Then the 4 s file's float32 trajectory at N=4
   through the kernels against the plain path (same prior,
   cuDNN deterministic), held to 1e-4 of the output's scale.
36. every sampler at the 4 s bucket in bf16, N=4, through the CLI: euler,
   heun, rk4, etd1, etd2, etd2-ms, etd2 with --deepcache 3, rk45 at rtol =
   atol = 1e-3 (its accepted and attempted steps), `--sampler picard
   --sweeps 4` on the 1 s and 4 s files (its peak memory) and pc with the
   etd predictor; K1 launches derived from N, the method and the module
   list (rk45: from its loop's drift evaluations), not from the reported
   NFE; K1 against plain at every shape (picard's 4-row calls included).
37. the server with `--sampler ode` (etd2, N=3) at its bf16 default, then
   with --deepcache 3, on phase 15's burst: replies 200 with X-NFE 8,
   /healthz's sampler and ode_method, exact K1 launches per warm-up call and
   batch, K1 against plain at every shape.
38. streaming with `--sampler ode --N 4` on phase 16's 12 s file: 18 x 10
   K1 launches per call of 8 chunks.
39. `python -m storm_tpu_torch.evaluate --mode storm` on a test split of 8
   pairs of 1-4 s beside phase 8's corpus (`--num_files 8 --batch 4 --N 4
   --csv`), pc then `--sampler ode`, on phase 5's checkpoint: 8 CSV rows,
   SI-SDR and ESTOI finite, PESQ NaN unless `pesq` imports, the mean +/- CI
   lines, 18 x NFE K1 launches per enhancer call, each row's SI-SDR within
   1e-4 dB of BucketedEnhancer's output for the same file, grouping and
   seed (cuDNN deterministic); the metrics' host wall beside the
   enhancement's.
40. the score-only and denoiser-only models and OUVP: one full-width f32
   score-only step's gradients against the plain path, then `python -m
   storm_tpu_torch.train` on phase 8's corpus (B=8, 256 frames, one epoch
   of 4 steps) with `--mode score-only` and `--mode denoiser-only
   --loss_type sisdr` in f32 (`--num_eval_files 4 --eval_N 4`), `--mode
   score-only` and `--mode regen-joint-training --sde ouvp` in bf16 (no
   evaluation): phase 8's checks, K1
   launches per step read from the module lists (a single net: 18 forward,
   15 backward, its input pyramid reading no parameter's output), the step
   and its peak memory beside StoRM's in the same dtype, K1 and its
   adjoint against plain at every shape.
41. `python -m storm_tpu_torch.enhancement` with phase 40's score-only and
   denoiser-only checkpoints on phase 5's files at the CLI's pc + ald
   (score-only at N=4, 8 forwards; the denoiser: 1) in f32,
   bf16 and `--quant int8 --dtype bfloat16` twice (calibrates, then loads):
   exact K1 and K3 launches per file, RTF beside StoRM's (phases 5, 19);
   every K1 shape (the score net's 4-channel pyramids) and K3 input against
   plain; the 4 s file's score-only f32 etd2 ODE (N=4) and the denoiser's
   output through the kernels against plain (1e-4 of the output's scale).
42. phase 40's OUVP StoRM bf16 checkpoint through the CLI (pc N=4 + ald; `--sampler
   ode --ode-method heun --N 4`): exact launches; `--ode-method etd2`
   raises the reference's message.
43. the server with `--mode score-only` (bf16, N=3, then `--deepcache 3`)
   and `--mode denoiser-only` on phase 15's burst (X-NFE 6, 6, 1;
   /healthz's mode), and denoiser-only streaming of phase 16's file, with
   exact launches per call.
44. `python -m storm_tpu_torch.evaluate --mode score-only` and
   `--mode denoiser-only` on phase 39's test split: 8 rows, each row's
   SI-SDR within 1e-4 dB of the enhancer's output.
45. the distilled student: one full-width f32 distill step (B=8, 256 x 256,
   etd2 targets of N=4: 9 teacher forwards) from phase 8's checkpoint
   through the kernels against the plain path: 18 x (1 + 9 + 1) = 198 K1
   and 15 adjoint launches, read from the module lists; the score net's
   gradients within phase 8's tolerances, the denoiser's 0; after Adam's
   step the denoiser is the teacher's bit for bit; the step's time and
   peak memory.
46. `python -m storm_tpu_torch.train --mode distill --teacher_ckpt` phase
   25's bf16 checkpoint, `--distill_N 4`, one epoch of 4 steps with
   `--num_eval_files 2`:
   phase 8's checks (launches per step from the module lists, all bf16;
   the evaluation's 2 forwards per call), the denoiser unmoved; the step
   and its peak memory beside StoRM's bf16 step.
47. `python -m storm_tpu_torch.enhancement --mode distill` on phase 5's
   files in f32, bf16 and int8 + bf16 twice (calibrates: 5 forwards; then
   loads): per file exactly 36 K1 and, int8, 110 K3 launches; RTF beside
   StoRM's; every K1 shape and K3 input against plain; `--deepcache 3`
   refused with the reference's message; the 4 s file's f32 output through
   the kernels against plain.
48. `--mode distill` with `--batch 4` on the 4 s file, streaming on phase
   16's file and the server at its bf16 default on phase 15's burst
   (X-NFE 2): 36 K1 launches per call.
49. `python -m storm_tpu_torch.evaluate --mode distill` on phase 39's test
   split: 8 rows, each row's SI-SDR within 1e-4 dB of the enhancer's.
50. `python -m storm_tpu_torch.bench --distill` (B=16, 256 frames, bf16,
   int8; 1 timed rep): its line, 5 calibration forwards + 36 K1 and 110 K3
   launches per call.
51. upfirdn2d and its adjoint against plain, f32 and bf16, at every shape
   an nf=32 StoRM (the quality run's width) gives them in a training step
   (B=8, 256 x 256) and a 4 s enhancement (B=1, 256 x 576).
52. captured CUDA graphs (utils/graphs.py), which every serving path
   above replays from a shape's third call: at the 4 s bucket (B=1) and
   (pc N=10 bf16) at B=4 on the 2.5 s bucket, the shape's first call runs
   the eager loop alone (no capture), its second captures, and a replay
   from the first call's generator state must equal it bit for bit, for
   StoRM pc N=10 + ald in f32, N=50 + ald in bf16 and int8 + bf16 (phase
   19's scales), dc3 bf16, etd2 and picard (4 sweeps) at N=10 in bf16 (dc3
   too), the score-only model's
   pc N=10 and the denoiser-only model in bf16, and the distilled NFE-2 path
   in bf16 and int8 + bf16; a replay of the f32 N=10 program from another
   generator state equals eager from it; weights swapped in place (`swapped_in`) are served by the
   next replay, bit for bit eager's with them.
53. one replay each of StoRM pc N=10 + ald in bf16, int8 + bf16 and dc3
   bf16 under torch.profiler: its K1 and K3 kernel events, by name, equal
   the derived counts (378; 378 and 1155; dc3's from the module list), and
   its busy share; 5 replays of the distilled int8 program add 5 times its
   recorded launches to the counters.
54. RTF graph against eager at B=1 on the 1 / 2.5 / 4 s files (bf16 pc
   + ald at N=50 at 4 s and N=10 at 1 and 2.5 s, dc3 bf16 N=10, distill
   NFE-2 bf16; f32 at N=10 and int8 + bf16 at 4 s),
   each replay equal to eager bit for bit; the second call's seconds; the
   busy share of phase 53's replays; each capture's seconds, the graph
   pool's growth and the static buffers' bytes.
55. the server at its bf16 default with --warmup_buckets 1,2.5,4: the
   warm-up captures 3 row sizes x 3 buckets and phase 21's burst captures
   nothing more and replays every batch; audio s/s, p50 and max against the
   same server with graphs=False; the streaming CLI on three copies of
   phase 16's 12 s file (the eager loop, the capture, a replay); phase 32's
   bench line (graphs).
Phases 56-58 run after phase 26, beside the other training phases, while
the process holds the least memory:
56. the trainer's programs (utils/train_graphs.py) at full width, B=8 x 256
   frames, cuDNN deterministic: StoRM joint in f32 and bf16, score-only
   bf16, denoiser-only sisdr f32 and the distilled student in bf16 (phase
   45's teacher, etd2 N=4): 3 eager steps and 3 through the program (the
   eager first call, the warm-up and capture, a replay) from the same
   model, batches and generator states: losses, parameters, EMA, Adam's
   state and the step counts equal after every step (max abs 0); each
   step timed (CUDA events), the peak allocated and reserved memory of
   each run, the capture's seconds and the pool's bytes; then a replay (two
   of the bf16 StoRM step) under torch.profiler: the counters grew by `step_launches` per replay
   (36 + 33 for StoRM), K1's kernel events equal them, and the replays'
   busy share; beside them the trainer's replayed periods (phases 8, 25).
57. `python -m storm_tpu_torch.train --dtype bfloat16` through its programs
   on phase 8's corpus, cuDNN deterministic: two epochs in one run, and a
   run resumed for the second epoch from the first's epoch-0 `last.pt`:
   the final `last.pt` equal bit for bit.
58. the asynchronous checkpoint (`ckpt.AsyncCheckpointManager`) of a
   full-width f32 StoRM state against the synchronous one, 2 saves each:
   the wall the loop waits, the async save's wall to its end, the files
   equal bit for bit.
Phases 59-64 (the NCSN++ family's other sizes and options, the time-domain
denoisers) run last:
59. a full-width DDPM + residual NCSN++ score net (every resampler a FIR
   with a 3x3 conv: upfirdn2d's stride-1 instance), f32 and bf16, cuDNN
   deterministic: one forward (B=1, 256 x 576) and one gradient (B=8, 256 x
   256) through the kernels against the plain path (1e-4 of the scale in
   f32, 1e-2 in bf16), with the module list's 12 launches per forward and 12
   adjoints per backward; a DDPM denoiser-only checkpoint through the
   enhancement CLI in f32 and bf16 (12 launches per file).
60. the stride-1 instance and its adjoint against plain at every shape of
   phase 59 (f32 atol = rtol = 1e-5; bf16 `compare`'s allowance), each
   timed beside the plain version, the depthwise `conv2d` computing the same
   function and the bound, and the sums per forward and per backward.
61. ncsnpplarge (65.6M parameters): a forward at 192 and 576 frames (its
   deepest level 3 and 9 frames wide) with the module list's 36 launches,
   K1 and its adjoint against plain at those shapes in f32 and bf16; StoRM
   with it as score net through the CLI on phase 5's files (N=4 + ald: 18 +
   36 x 8 launches per file) and its captured program against the eager
   loop at 4 s, bit for bit.
62. `python -m storm_tpu_torch.train --backbone_score ncsnpplarge --dtype
   bfloat16`, 4 steps at B=8 x 256 (54 + 51 launches per step), its step
   and peak memory; one eager f32 step's peak at B=8 (or the largest of 4
   and 2 that fits).
63. `python -m storm_tpu_torch.train --mode denoiser-only --backbone_denoiser
   convtasnet --return_time --loss_type sisdr`, 4 steps at B=8 in f32: no
   K1 launch, its step and memory; its checkpoint through the CLI.
64. StoRM with a ConvTasNet and with an ae-ncsnpp denoiser through the CLI
   on phase 5's files (N=4 + ald; per file 144 and 162 launches), and the
   ConvTasNet StoRM server at its bf16 default on phase 15's burst.
65. GaGNet at the reference CLI's width (c 64, d_feat 448, p 2, q 3,
   dilations 1, 2, 5, 9, U^2 encoder, concatenated skips, IN; 256 bins
   padded to 257), seeded weights, on the 1, 2.5 and 4 s buckets: its
   parameter count, forward ms in f32 and bf16 (no K1 launch), bf16
   against its own f32 output (at most 0.5 in L2: the reference's own
   bf16 GaGNet parts by 0.46 at 16 frames on the CPU), and one captured
   replay at 4 s equal to the eager forward bit for bit.
66. StoRM with that GaGNet denoiser and the 27.8M NCSN++ score net through
   the CLI on phase 5's files in f32, bf16 and int8 + bf16 (N=4 + ald: per
   file the score net's 18 x 8 K1 launches and, int8, 55 x 8 K3; GaGNet
   adds none and has no quantizable conv), RTF per file; its captured
   program at N=10 + ald at 4 s in bf16 against the eager
   loop; the server at its bf16 default on phase 15's burst.
67. `python -m storm_tpu_torch.train` with GaGNet, 4 steps at B=8 x 256
   each, through its programs: StoRM with a GaGNet denoiser in bf16 (the
   score net's 18 forward and 18 backward launches per step), and
   `--mode denoiser-only --backbone_denoiser gagnet` in f32 with IN and
   with BN (batch statistics; no K1 launch): step ms and peak memory.
68. A reference Lightning `.ckpt` of a GaGNet-BN denoiser, synthesized from
   seeded tensors with torch-ema `shadow_params` and positive
   `running_var`, through `python -m storm_tpu_torch.compat.convert`; the
   converted `.pt` through the enhancement CLI, which must load the side
   file and give what the model's `enhance` gives with those statistics
   (and not what it gives with the batch's); `evaluate` on the `tt` split.
69. multichannel input: a full-width StoRM of 2 spatial channels (both
   nets take 2-channel spectrograms: the score net's input pyramid is 12
   channels wide, the denoiser's 4) through the CLI on synthesized
   2-channel files of 1, 2.5 and 4 s in f32, bf16 and int8 + bf16 (N=4 +
   ald), `--batch 4` and a 12 s 2-channel stream in bf16 (N=3): 2-channel
   outputs of the inputs' lengths, exact K1 / K3 launches per enhancer call
   from the module list and the calibrated scales; the server (bf16, N=3)
   on 3-channel payloads (served on their first 2) and a mono one (400),
   `spatial_channels` in /healthz and /stats; K1 and K3 against plain at
   every shape these runs gave them; the program at N=10 + ald in bf16 at
   2.5 s against the eager loop, bit for bit, its RTF beside phase 54's
   one-channel row.
70. `python -m storm_tpu_torch.train --spatial_channels 2 --dtype bfloat16`,
   4 steps at B=8 x 256 on a 2-channel corpus through its programs (36 + 33
   launches per step): step period and peak memory beside phase 25's; the
   checkpoint enhances a 2-channel file; K1 and its adjoint against plain
   at the shapes it gave them.
71. data-parallel training on one card: `python -m storm_tpu_torch.train`
   (f32, graphs) for 3 steps at global B=8 as one process, then as two
   processes under gloo (STORM_TPU_* variables; 4 rows each, the same
   seed), each a subprocess of this script (`--train_worker`, timed per
   step with CUDA events): every step's loss and the validation loss held
   to the one process's (rtol 5e-3 and 1e-3), step 1's summed gradients
   within 1e-5 of the one process's by the norm, the parameters after step
   1 within 2 lr, 36 + 33 launches per step on every process, each process's
   step period, peak memory and the all-reduce's ms per step; only process
   0 writes metrics and checkpoints, and its last.pt enhances; K1 and its
   adjoint against plain at the processes' B=4 shapes. Then GaGNet-BN
   denoiser-only at the reference CLI's width the same way, its BN moments
   over both processes' rows (eager, `execution` "eager: BN moments across
   processes (gloo)"; the one process replays its programs): every step's
   loss at rtol 5e-3, and step 1's gradients of either run held to a
   float64 step on the same weights and batch, the two processes' summed
   within 1.5x the one process's distance (float32 rounding, amplified
   through its 169 BN layers, puts both ~6e-3 from it).
72. serving across devices on one card: `--data_parallel` through the CLI
   (one replica: minibatch 8; N=1 + ald) on phase 5's files against
   `--batch 8`, bit for bit; one full-width score forward (B=1, 576 frames) over 2 and 4
   shards on cuda:0 (`ShardedNCSNpp`) against unsharded, f32 (1e-5 of the
   output's scale), bf16 and int8 + bf16 (against the f32 forward, within
   2x the unsharded one's distance), 18 K1 launches per shard (and the
   int8 scales' count of K3 launches per shard); ncsnpplarge over 4
   unequal shards and the DDPM + residual net (12 stride-1 launches per
   shard) over 2 and 4; StoRM enhancing the 4 s file at N=1 + ald with
   `seq_parallel` 2 and 4 (`devices=["cuda:0"] * k`), f32 and bf16: the
   captured program against the eager loop bit for bit, and against
   unsharded serving (f32 1e-4 of the scale; bf16 in the 2x form); K1 and
   K3 against plain at every shard shape. More shards than the coarsest
   level holds frames: ncsnpplarge at 64 frames over 4 shards and at 128
   over 4 and 8 (1 and 2 coarse frames: parts that start on odd frames, and
   parts empty at the deep levels), f32 and bf16, K1 exactly the plan's
   launches (none for an empty part), the 128-frame call timed against
   unsharded; `--seq_parallel 4` through the CLI on the 1 s file with
   phase 61's StoRM (its ncsnpplarge score net's coarsest level 3 frames)
   against the same CLI unsharded, and that group's captured program
   against its eager loop.
73. dataset creation on the card's machine: a seeded tree (5 speech files
   of 2.3-3.1 s in one split, wham-style and CHiME-style noise) through
   `python -m storm_tpu_torch.preprocessing.create_data --task derev+enh`
   (a process of its own; `--dummy`, 2 corruptions a file), then in this
   process `--task bwe --bwe-method decimate`, `--task enh --noise chime`,
   `simulate_wind_noise --n 2` and `nonlinear_mixing`: the reference's
   layout and file names, clean and noisy of each pair of one length, the
   wind files 8 s; one batch of the derev+enh corpus through
   `SpecsDataModule` (format timit: `audio/<split>/{clean,noisy}`) and one
   full-width f32 StoRM step on it (`TrainPrograms`, eager): a finite loss
   and the module list's 36 + 33 K1 launches; K1 and its adjoint against
   plain at its shapes.
74. `storm_tpu_torch.scripts.stream_quality` at full width in bf16 on
   phase 5's checkpoint: one 64 s file (8064 frames) whole at B=1 and in 4
   s chunks overlapping by 0.5 s, 8 per call, N=3 without a corrector: one
   whole and 3 streamed enhancer calls of 18 x 4 K1 launches each, the
   whole call's wall s, RTF and peak allocated memory, the streamed RTF,
   the SUMMARY line (finite); K1-bf16 against plain at every shape the run
   gave it; one int8 + bf16 score forward at 8064 frames (scales from a bf16
   forward there): 55 K3 launches, codes identical to plain at each input;
   the widest K1-bf16 call and K3 input event-timed beside plain, the
   library call (K1) and the bound.

A serving path's first call of a shape runs the eager loop, its second
also captures the shape's graph, and later calls replay it. To keep the
script inside its time, the CLI phases 5, 11, 19, 30, 35, 36 and 42 and
the batched, evaluate and score-only runs (14, 19, 39, 41, 44) run at N=4
(9 forwards per file, 10 for the ODE), not at the CLI's default N=50, the
servers and streaming (15, 16, 21, 22, 31, 37, 43, 48, 55) at N=3, the
distilled student's teacher targets (45, 46, 56) at N=4 and stream_quality
(74) at N=3. The RTF at the defaults, graph and
eager, is phase 54's.

Each phase's header line ends with the seconds since the script started.

A profile's kernel times come from its device events, each counted once;
shares are of the summed kernel time. The busy time is the union of the
kernels' intervals, which kernels running side by side on several streams
(cuDNN's FFT convolutions in a train step) do not count twice. A profile
fails if K1's or K3's wrapper counted launches in the traced window and one
of their groups (kernel-name stems: K1's down and up configurations) matches
no device event, or if the groups' events fall short of 95% of the counted
launches or exceed them.

The line before the last holds the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import functools
import http.client
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

# before torch allocates on the card: the allocator the training CLI runs
# with (storm_tpu_torch/utils/train_graphs.py `use_expandable_segments`)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch import backbones, enhancement, evaluate, serve, train
from storm_tpu_torch.backbones.gagnet import batch_norms
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, ShardedNCSNpp, count_parameters
from storm_tpu_torch.ckpt import (AsyncCheckpointManager, CheckpointManager,
                                  load_training_checkpoint, save_checkpoint)
from storm_tpu_torch.compat import convert as ref_convert
from storm_tpu_torch.compat.torch_ckpt import BN_BUFFERS
from storm_tpu_torch.data.audio import load_wav, save_wav, wav_info
from storm_tpu_torch.data.datamodule import SpecsDataModule
from storm_tpu_torch.data.datasets import Specs
from storm_tpu_torch.kernels import LAUNCH_COUNTERS as LAUNCH_COUNTERS_ALL
from storm_tpu_torch.kernels import build
from storm_tpu_torch.kernels import fused_act as kfa
from storm_tpu_torch.kernels import quant as kq
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models import quant as quant_mod
from storm_tpu_torch.models.base import init_train_state, swapped_in
from storm_tpu_torch.models.discriminative import DiscriminativeModel
from storm_tpu_torch.models.distill import DEEPCACHE_REFUSAL, DistilledModel
from storm_tpu_torch.models.factory import build_model, resolve_device
from storm_tpu_torch.models.score import ScoreModel
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.nn import qconv, resample, seqpar
from storm_tpu_torch.nn.cast import cast_params
from storm_tpu_torch.nn.init import reset_parameters
from storm_tpu_torch.preprocessing import create_data, nonlinear_mixing, simulate_wind_noise
from storm_tpu_torch.nn.layers import (Combine, Downsample, GroupNorm, ResnetBlockBigGANpp,
                                       Upsample, group_norm)
from storm_tpu_torch.sampling import samplers
from storm_tpu_torch.scripts import stream_quality
from storm_tpu_torch.signal.transforms import pad_spec_amount
from storm_tpu_torch.utils import graphs, inference, train_graphs
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.metrics import si_sdr
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import (batch_stats_path, load_gagnet_batch_stats,
                                           n_quantized, scale_cache_path)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

NF, CH_MULT = 128, (1, 2, 2, 2)
SR, HOP = 16000, 128
BUCKET = 64 * HOP  # BucketedEnhancer pads every waveform to a multiple of 64 hops


def bucket_frames(samples: int) -> int:
    """NCSN++ input width of a wave of `samples`, as BucketedEnhancer gives
    it: the wave padded to its bucket, its centred STFT frames padded to 64."""
    n = 1 + -(-samples // BUCKET) * BUCKET // HOP
    return n + pad_spec_amount(n)


def padded_frames(seconds: float) -> int:
    return bucket_frames(int(seconds * SR))


def bucketed(y: np.ndarray) -> torch.Tensor:
    """(B, T) waves on the card, zero-padded at the tail to their bucket as
    BucketedEnhancer pads them (for the phases that call the model directly)."""
    T = y.shape[-1]
    return torch.from_numpy(np.pad(y, [(0, 0), (0, -(-T // BUCKET) * BUCKET - T)])).cuda()


FREQS, FRAMES = 256, padded_frames(4.0)  # a 4 s request: 65536 samples, 513 frames -> 576
FIR = resample.setup_kernel((1, 3, 3, 1))
CONFIGS = {"down": dict(up=1, down=2, pad=(1, 1), kernel=FIR),
           "up": dict(up=2, down=1, pad=(2, 1), kernel=FIR * 4.0),
           # the stride-1 instance: after upsample_conv_2d's transposed conv
           # (its FIR times 4), before conv_downsample_2d's strided one
           "same1": dict(up=1, down=1, pad=(1, 1), kernel=FIR * 4.0),
           "same2": dict(up=1, down=1, pad=(2, 2), kernel=FIR)}


def config_of(up: int, down: int, pad) -> str:
    """The CONFIGS name of an upfirdn2d call."""
    if up == 2:
        return "up"
    return "down" if down == 2 else f"same{int(pad[0])}"
# full-width StoRM; init_scale 1 so that no branch of the random net starts at ~0
STORM_CONFIG = {"mode": "regen-joint-training", "init_scale": 1.0}
# the CLI's defaults (pc, ald, N=50: 1 denoiser + N x (ald + predictor)), which the bench,
# the profiles and phase 54 run; the CLI phases run N_STEPS, to keep the script inside its
# time
DEFAULT_N, DEFAULT_NFE = 50, 1 + 50 * 2
N_STEPS, NFE = 4, 1 + 4 * 2
SECONDS = (1.0, 2.5, 4.0)
GAP_S = 0.02  # host pause between the runs of `device_ms`
L2_FLUSH_BYTES = 256 << 20  # read before each call of `device_ms`: 5x the H100's 50 MB L2
# a profile fails unless the device events of each counted kernel number at
# least this share of its wrapper's counted launches (the profiler may drop a
# few) and at most all of them
PROFILE_MIN_MATCHED = 0.95


# the other widths the enhancement path gives upfirdn2d (the trained
# checkpoint's 1 s file included): 192 and 384
OTHER_FRAMES = sorted({padded_frames(s) for s in SECONDS} - {FRAMES})
# training: the CLI defaults' batch and crop (256 frames = 32640 samples, 2.04 s)
TRAIN_B, TRAIN_FRAMES, TRAIN_STEPS = 8, 256, 4
TRAIN_AUDIO_S = (TRAIN_FRAMES - 1) * 128 / SR
TRAIN_FILES, VALID_FILES, FILE_S = 32, 4, 2.5  # 4 steps per epoch, 2 epochs
# distillation with etd2 targets of N=4 (the trainer's default is 8), 2 x 4 + 1
# teacher forwards, to keep the script inside its time
DISTILL_N, DISTILL_METHOD = 4, "etd2"
DISTILL_TEACHER_FORWARDS = 2 * DISTILL_N + 1
F32_EVAL_N = 4  # the float32 evaluation's reverse steps (bf16's: the default, 30)
# upfirdn2d launches per joint-training step: 18 per forward of each net, and
# a backward for every call whose input needs a gradient, which is all but
# the denoiser's input pyramid (3 calls on the raw noisy spec)
STEP_FWD, STEP_BWD = 2 * 18, 2 * 18 - 3
# gradients through the kernels against the plain path, per tensor:
# max|kernel - plain| <= GRAD_RTOL * max|plain| + GRAD_FLOOR * (largest gradient
# element), the floor for tensors whose exact gradient is 0 (the attention key
# bias); and the global L2 norm of the difference <= GRAD_NORM_RTOL * the norm.
# The two paths differ only in K1's summation order.
GRAD_RTOL, GRAD_FLOOR, GRAD_NORM_RTOL = 1e-3, 1e-5, 1e-4
# int8 serving at --quant_min_channels 128: every resblock's Conv_0, Conv_1 and
# Conv_2 of each full-width net; per file 1 denoiser forward and N x 2 score
# forwards, each launching the quantizer once per quantized conv
QUANT_MIN_CHANNELS, N_QUANT = 128, 55
K3_PER_FILE = N_QUANT + N_QUANT * N_STEPS * 2
# calibration (quantization off): the denoiser, a trajectory of min(N, 10)
# steps, then the prior and 8 probes spread over it (np.unique of 8 indices)
CALIB_N = min(N_STEPS, 10)


def calib_forwards(calib_n: int, probes: int = 8) -> int:
    return 1 + calib_n + 1 + len(np.unique(np.linspace(0, calib_n - 1, probes).astype(int)))


CALIB_FORWARDS = calib_forwards(CALIB_N)
PROBE_SHAPE, PROBE_S = (16 * 256 * 256, 128), 12.7  # scripts/perf_fusion_probe.py's qkernel
K2_SHAPES = [(8, 256, 256, 128), (3, 17, 33, 6)]


T_START = time.perf_counter()


def phase_header(title: str, **kwargs):
    """A phase's header line, with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - T_START:.1f} s]", **kwargs)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def k1_calls(pyramid_ch: int, frames: int = FRAMES):
    """(config, C, H, W) of the 18 upfirdn2d calls of one NCSN++ forward."""
    calls = []
    L = len(CH_MULT)
    for i in range(L - 1):  # down resblocks (h and x), then the input pyramid
        H, W = FREQS >> i, frames >> i
        calls += [("down", NF * CH_MULT[i], H, W)] * 2 + [("down", pyramid_ch, H, W)]
    for i in range(L - 1, 0, -1):  # output pyramid, then up resblocks (h and x)
        H, W = FREQS >> i, frames >> i
        calls += [("up", pyramid_ch, H, W)] + [("up", NF * CH_MULT[i], H, W)] * 2
    return calls


def k1_bwd_calls():
    """(forward config, C, H, W) of the upfirdn2d calls whose backward runs in
    one joint-training step: every call of the score net (its input holds
    D(Y)), every call of the denoiser but its input pyramid's."""
    denoiser = [c for c in k1_calls(2, TRAIN_FRAMES) if c[:2] != ("down", 2)]
    calls = denoiser + k1_calls(6, TRAIN_FRAMES)
    check(len(calls) == STEP_BWD, f"{len(calls)} backward calls, expected {STEP_BWD}")
    return calls


def time_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_events(prof):
    """The trace's kernel events as sorted (start us, end us, name, stream)
    tuples: the spans of record_function ranges on the device's timeline
    (user annotations, such as the optimizer's step) cover kernels and are
    left out; an event listed twice (same name, stream and interval) counts
    once."""
    from torch.autograd import DeviceType

    return sorted({(e.time_range.start, e.time_range.end, e.name,
                    getattr(e, "device_resource_id", e.thread))
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)})


def device_ms(fns, stem: str, reps: int = 20):
    """Mean device time per call (ms) of each function in `fns`, each of which
    launches one kernel whose name holds `stem`: the durations of that
    kernel's events in a torch.profiler trace of `reps` calls of each. Unlike
    `time_ms`, the host's enqueue between calls does not count. Each call
    finds the L2 cold, as the memory bound assumes: a read of L2_FLUSH_BYTES
    (another kernel, not counted) runs before it. A pause of GAP_S after each
    function's calls splits the trace's events into one run per function
    (the profiler may miss a few events, so they are not split by count).
    A first run of the first function, dropped, takes the tracer's start:
    it has been seen to lose half the events of the run it starts with."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in [fns[0], *fns]:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
            time.sleep(GAP_S)
    runs, last_end = [], -float("inf")
    for start, end, name, _ in kernel_events(prof):
        if stem not in name:
            continue
        if start - last_end > GAP_S * 1e6 / 2:  # microseconds
            runs.append([])
        runs[-1].append(end - start)
        last_end = end
    runs = runs[-len(fns):]  # without the first run, or what the tracer kept of it
    check(len(runs) == len(fns) and all(len(r) >= reps // 2 for r in runs),
          f"device events of {stem}: runs of {[len(r) for r in runs]}, expected "
          f"{len(fns)} runs of {reps}")
    return [statistics.mean(r) / 1e3 for r in runs]


def library_call(cfg: str, C: int, backward: bool = False, dtype=torch.float32):
    """One PyTorch call computing the same function (yardstick only); with
    `backward`, the adjoint of the forward call of `cfg`, which is the other
    call with the same weight. In bfloat16 the weight is the FIR cast to it,
    which is exact."""
    k = torch.as_tensor(CONFIGS[cfg]["kernel"], device="cuda").to(dtype)
    if cfg.startswith("same"):  # a depthwise correlation with the flipped FIR, padded pad0;
        # the adjoint: with the FIR as is, padded 3 - pad0
        pad0 = CONFIGS[cfg]["pad"][0]
        if backward:
            w = k.expand(C, 1, 4, 4).contiguous()
            return lambda g: F.conv2d(g, w, padding=3 - pad0, groups=C)
        w = k.flip(0, 1).expand(C, 1, 4, 4).contiguous()
        return lambda x: F.conv2d(x, w, padding=pad0, groups=C)
    if cfg == "down":  # correlation with the flipped FIR on the 1-padded input
        w = k.flip(0, 1).expand(C, 1, 4, 4).contiguous()
        if backward:
            return lambda g: F.conv_transpose2d(g, w, stride=2, padding=1, groups=C)
        return lambda x: F.conv2d(x, w, stride=2, padding=1, groups=C)
    w = k.expand(C, 1, 4, 4).contiguous()  # transposed conv with the FIR as is
    if backward:
        return lambda g: F.conv2d(g, w, stride=2, padding=1, groups=C)
    return lambda x: F.conv_transpose2d(x, w, stride=2, padding=1, groups=C)


def bound_ms(n_in: int, n_out: int, taps: int, elem_bytes: int = 4):
    """(bytes bound, operations bound) in ms: in and out once (`elem_bytes`
    per element: 4 float32, 2 bfloat16) over the memory rate; `taps`
    multiply-adds per output, in float32 either way, over the f32 peak."""
    return (elem_bytes * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3,
            2.0 * taps * n_out / PEAK_F32_FLOP_PER_S * 1e3)


ASYM = torch.randn(4, 4, generator=torch.Generator().manual_seed(1)).numpy()


def forward_shapes(frames: int):
    return sorted(set(k1_calls(6, frames) + k1_calls(2, frames)),
                  key=lambda s: (s[0], -s[1], -s[2]))


# bfloat16 checks of a kernel against its plain version, by kernel and FIR
# (NCSN++'s or the asymmetric one): [elements compared, elements that differ]
BF16_FLIPS = {k: {"ncsnpp": [0, 0], "asym": [0, 0]} for k in ("upfirdn2d", "upfirdn2d_bwd")}


def ulps_of_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bfloat16 ulps of max |want|: 2^-7 of its leading
    power of two."""
    scale = want.float().abs().max().clamp_min(2.0 ** -126)
    return ((got.float() - want.float()).abs().max()
            / torch.exp2(torch.floor(torch.log2(scale)) - 7)).item()


def compare(what: str, got: torch.Tensor, want: torch.Tensor, kernel: str = "upfirdn2d",
            terms: torch.Tensor = None, fir: str = "ncsnpp") -> float:
    """max |got - want|; fails unless they agree to atol = rtol = 1e-5 in
    float32, or in bfloat16 to 1 ulp of each element plus 2^-18 of `terms`
    (the sum of the element's products' magnitudes): both sum in float32
    and round once, but the kernel's fused multiply-add rounds a product
    that is not exact once less, which shows where an asymmetric FIR's sum
    cancels; NCSN++'s FIR's products are exact. The elements that differ
    are counted in BF16_FLIPS[kernel][fir]."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(got.dtype == want.dtype, f"{what}: dtype {got.dtype} vs {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        w = want.float().abs().clamp_min(2.0 ** -126)
        allowed = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -18 * terms.float()
        worst = ((got.float() - want.float()).abs() / allowed).max().item()
        flips = int((got != want).sum().item())
        BF16_FLIPS[kernel][fir][0] += got.numel()
        BF16_FLIPS[kernel][fir][1] += flips
        check(worst <= 1.0, f"{what}: kernel {worst:.2f} of its allowance from plain ({flips} "
                            f"elements differ)")
    else:
        check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
              f"{what}: kernel disagrees with plain (max {err:.3e})")
    return err


def check_forward(cfg: str, x: torch.Tensor) -> float:
    """upfirdn2d_cuda against the plain version on x (float32 or bfloat16),
    both FIRs."""
    c = CONFIGS[cfg]
    args = dict(up=c["up"], down=c["down"], pad=c["pad"])
    return max(compare(f"upfirdn2d {cfg} {tuple(x.shape)} {x.dtype}",
                       kup.upfirdn2d_cuda(x, kern, **args), kup.upfirdn2d_plain(x, kern, **args),
                       terms=kup.upfirdn2d_plain(x.abs(), np.abs(kern), **args), fir=fir)
               for fir, kern in (("ncsnpp", c["kernel"]), ("asym", ASYM)))


def phase_kernel_vs_plain(gen: torch.Generator):
    per_shape, launch, max_err = {}, {}, 0.0
    for frames in OTHER_FRAMES:  # correctness only
        errs = [check_forward(cfg, torch.randn(1, C, H, W, device="cuda", generator=gen))
                for cfg, C, H, W in forward_shapes(frames)]
        max_err = max(max_err, *errs)
        print(f"  upfirdn2d at 256 x {frames} (B=1): {len(errs)} shapes agree with plain, "
              f"max abs err {max(errs):.2e}", flush=True)
    for cfg, C, H, W in forward_shapes(FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        x = torch.randn(1, C, H, W, device="cuda", generator=gen)
        max_err = max(max_err, check_forward(cfg, x))
        lib = library_call(cfg, C)
        want = kup.upfirdn2d_plain(x, c["kernel"], **args)
        lib_err = (lib(x) - want).abs().max().item()
        check(lib_err <= 1e-5 + 1e-5 * want.abs().max().item(),
              f"library yardstick {cfg} C={C}: not the same function (max {lib_err:.3e})")
        ms = time_ms(lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args))
        plain_ms = time_ms(lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), reps=5)
        library_ms = time_ms(lambda: lib(x))
        Ho, Wo = want.shape[-2:]
        bound_bytes_ms, bound_ops_ms = bound_ms(C * H * W, C * Ho * Wo, 16 // (c["up"] ** 2))
        per_shape[(cfg, C, H, W)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bytes_ms=bound_bytes_ms, ops_ms=bound_ops_ms,
                                         lib_err=lib_err, out=f"{Ho}x{Wo}")
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_cuda, x, c["kernel"], **args)
    print_per_shape("upfirdn2d", per_shape, launch, "upfirdn2d_", k1_calls(6), "score forward")
    return per_shape, max_err


def print_per_shape(what: str, per_shape, launch, stem: str, calls=None, per: str = ""):
    """Add each shape's device time to its times and print one line per shape;
    with `calls` (shapes, repeated as the path runs them), then one line of
    their sums: the kernel's row per forward or per step."""
    for key, dev in zip(launch, device_ms(list(launch.values()), stem)):
        per_shape[key]["device_ms"] = dev
    if calls is not None:
        total = {k: sum(per_shape[c][k] for c in calls)
                 for k in ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        bound = max(total["bytes_ms"], total["ops_ms"])
        by = "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"
        print(f"  {what} per {per} ({len(calls)} calls): device_ms={total['device_ms']:.5f} "
              f"bound_ms={bound:.5f} ({by}) device/bound={total['device_ms'] / bound:.3f} "
              f"ms={total['ms']:.5f} plain_ms={total['plain_ms']:.5f} "
              f"library_ms={total['library_ms']:.5f}", flush=True)
    for (cfg, C, H, W), r in per_shape.items():
        by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
        print(f"  {what} {cfg:4s} C={C:3d} {H:3d}x{W:3d} -> {r['out']}: ms={r['ms']:.5f} "
              f"device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} "
              f"({by}) device/bound={r['device_ms'] / max(r['bytes_ms'], r['ops_ms']):.2f} "
              f"lib_err={r['lib_err']:.2e}"
              + (f" flips={r['flips']}" if "flips" in r else "")
              + (f" path={r['path']}" if "path" in r else ""), flush=True)


def phase_full_width_forward(gen: torch.Generator):
    net = NCSNpp(input_channels=6, init_scale=1.0)
    reset_parameters(net, torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    check(count_parameters(net) > 27_000_000, "NCSN++ is not full width")
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode():
        kup.upfirdn2d_cuda.launches = 0
        out_k = net(x, t)
        torch.cuda.synchronize()
        launches = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            out_p = net(x, t)
            torch.cuda.synchronize()
            check(kup.upfirdn2d_cuda.launches == launches, "plain path launched the kernel")
        fwd_ms = time_ms(lambda: net(x, t), reps=3, repeats=3)
    check(launches == 18, f"one NCSN++ forward launched upfirdn2d {launches} times, expected 18")
    check(bool(torch.isfinite(out_k).all()), "NCSN++ output is not finite")
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    print(f"  NCSN++ {count_parameters(net)} params, out {tuple(out_k.shape)}: "
          f"kernel vs plain max abs err {err:.3e} (scale {scale:.3e}), forward {fwd_ms:.2f} ms",
          flush=True)
    check(err <= 1e-4 * scale, f"full-width NCSN++ kernel path disagrees with plain ({err:.3e})")


def synth_wav(seconds: float, i: int, rng: np.random.Generator) -> np.ndarray:
    """A modulated tone in white noise, float32 at 16 kHz."""
    n = int(seconds * SR)
    tt = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * (i + 1) * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * tt))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def write_wavs(directory: str):
    """One synthesized file per entry of SECONDS; returns {name: samples}."""
    os.makedirs(directory)
    rng = np.random.default_rng(0)
    lengths = {}
    for i, s in enumerate(SECONDS):
        name = f"utt{i}_{s:.1f}s.wav"
        x = synth_wav(s, i, rng)
        save_wav(os.path.join(directory, name), x, SR)
        lengths[name] = x.shape[-1]
    return lengths


def captured(fn, *args):
    """fn(*args) with its standard output captured, then printed indented;
    returns (fn's result, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    torch.cuda.synchronize()
    text = buf.getvalue()
    print("".join(f"    | {line}\n" for line in text.splitlines()), end="", flush=True)
    return result, text


def run_enhancement(argv, outputs=None) -> str:
    """`python -m storm_tpu_torch.enhancement` in this process; its standard
    output is printed and returned. With `outputs` (a dict), each enhanced
    waveform is also kept there by file name, as float32 before the WAV
    writer's 16-bit rounding."""
    if outputs is None:
        return captured(enhancement.main, argv)[1]
    real = enhancement.save_wav

    def save_wav(path, x, sr=SR):
        outputs[os.path.basename(path)] = np.array(x, np.float32)
        real(path, x, sr)

    with mock.patch.object(enhancement, "save_wav", save_wav):
        return captured(enhancement.main, argv)[1]


def rtf_of(text: str):
    """{file name: RTF} from the CLI's --timeit lines."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\S+\.wav): nfe=\d+ rtf=([0-9.]+)", text, re.M)}


def check_outputs(out: str, lengths):
    for name, n in lengths.items():
        x, sr = load_wav(os.path.join(out, name))
        check(sr == SR and x.shape == (1, n), f"{name}: output shape {x.shape}, expected (1, {n})")
        check(bool(np.isfinite(x).all()), f"{name}: output not finite")


def phase_main_path(workdir: str):
    """Returns (upfirdn2d launches, {file: RTF}, {file: samples}, {file: output});
    leaves the checkpoint and the files in `workdir` for phase 11."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    ckpt = os.path.join(workdir, "storm.pt")
    save_checkpoint(ckpt, STORM_CONFIG, model.state_dict())
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced")
    lengths = write_wavs(noisy)

    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    outputs = {}
    text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                            "--mode", "storm", "--timeit", "--device", "cuda",
                            "--N", str(N_STEPS)], outputs)
    wall = time.perf_counter() - t0
    launches = kup.upfirdn2d_cuda.launches
    check_outputs(out, lengths)
    expected = 18 * NFE * len(SECONDS)
    print(f"  enhanced {len(SECONDS)} files ({sum(SECONDS)} s of audio) in {wall:.2f} s wall; "
          f"upfirdn2d launches {launches} (expected 18 x {NFE} x {len(SECONDS)} = {expected})",
          flush=True)
    check(launches == expected, f"upfirdn2d launched {launches} times, expected {expected}")

    # the whole path once more on the shortest file, kernel against plain, same noise
    y = bucketed(load_wav(os.path.join(noisy, next(iter(lengths))))[0])
    runs = []
    for plain in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(0)
        ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
               else contextlib.nullcontext())
        with ctx:
            x_hat, _ = model.enhance(y, N=N_STEPS, corrector="ald", generator=gen)
        runs.append(x_hat)
    err = (runs[0] - runs[1]).abs().max().item()
    scale = runs[1].abs().max().item()
    print(f"  enhance (1 s file) kernel vs plain: max abs err {err:.3e} (scale {scale:.3e})",
          flush=True)
    check(err <= 1e-3 * scale, f"main path with the kernel disagrees with plain ({err:.3e})")
    return launches, rtf_of(text), lengths, outputs


def phase_backward_vs_plain(gen: torch.Generator):
    """upfirdn2d at each forward shape of a train step, through the autograd
    Function the model calls: its output, and where the step takes one its
    gradient, against the plain version. Returns (per-shape backward times,
    backward max error, forward max error)."""
    bwd_calls = set(k1_bwd_calls())
    per_shape, launch, max_err, fwd_err = {}, {}, 0.0, 0.0
    for cfg, C, H, W in forward_shapes(TRAIN_FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        needs_grad = (cfg, C, H, W) in bwd_calls
        what = f"{cfg} B={TRAIN_B} C={C} {H}x{W}"
        x = torch.randn(TRAIN_B, C, H, W, device="cuda", generator=gen)
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(TRAIN_B, C, Ho, Wo, device="cuda", generator=gen)
        for kern in (ASYM, c["kernel"]):  # the NCSN++ FIR last: `want` serves below
            xk = x.clone().requires_grad_(needs_grad)
            xp = x.clone().requires_grad_(needs_grad)
            out_k, out_p = kup.upfirdn2d(xk, kern, **args), kup.upfirdn2d_plain(xp, kern, **args)
            fwd_err = max(fwd_err, compare(f"upfirdn2d {what}", out_k.detach(), out_p.detach()))
            if needs_grad:
                (got,) = torch.autograd.grad(out_k, xk, g)
                (want,) = torch.autograd.grad(out_p, xp, g)
                check(got.shape == x.shape, f"upfirdn2d_bwd {what}: shape")
                max_err = max(max_err, compare(f"upfirdn2d_bwd {what}", got, want))
        if not needs_grad:
            continue
        lib = library_call(cfg, C, backward=True)
        lib_err = (lib(g) - want).abs().max().item()
        check(lib_err <= 1e-5 + 1e-5 * want.abs().max().item(),
              f"library yardstick bwd {cfg} C={C}: not the same function (max {lib_err:.3e})")
        bwd = (g, c["kernel"], c["up"], c["down"], c["pad"], (H, W))
        ms = time_ms(lambda: kup.upfirdn2d_bwd_cuda(*bwd))
        plain_ms = time_ms(lambda: kup.upfirdn2d_bwd_plain(*bwd), reps=5)
        library_ms = time_ms(lambda: lib(g))
        bytes_ms, ops_ms = bound_ms(g.numel(), x.numel(), 16 // (c["down"] ** 2))
        per_shape[(cfg, C, H, W)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bytes_ms=bytes_ms, ops_ms=ops_ms, lib_err=lib_err,
                                         out=f"(g {Ho}x{Wo} -> grad x {H}x{W})")
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_bwd_cuda, *bwd)
    print_per_shape(f"upfirdn2d_bwd (B={TRAIN_B}) of", per_shape, launch, "upfirdn2d_",
                    k1_bwd_calls(), "joint-training step")
    print(f"  forward at every train-step shape: max abs err {fwd_err:.2e}; backward: "
          f"max abs err {max_err:.2e}", flush=True)
    return per_shape, max_err, fwd_err


def grads_of(model, batch, t, z):
    model.compute_gradients(batch, t, z)
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def phase_train_gradients(gen: torch.Generator, config=STORM_CONFIG):
    """One full-width step's gradients of the model of `config` through the
    kernels against the plain path, with exactly the step's launches read
    from the module list (`step_launches`)."""
    model = build_model(config, device="cuda", seed=0).train()
    want_counts = step_launches(config["mode"])
    B = 2
    x = 0.3 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    y = x + 0.2 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    t = torch.tensor([0.3, 0.8], device="cuda")
    z = torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen) / 2 ** 0.5
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        g_k = grads_of(model, (x, y), t, z)
        torch.cuda.synchronize()
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            g_p = grads_of(model, (x, y), t, z)
            torch.cuda.synchronize()
        check(counts == (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches),
              "the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    check(counts == want_counts,
          f"one step's gradients launched {counts}, expected {want_counts}")
    check(all(bool(torch.isfinite(v).all()) for v in g_k.values()), "gradients not finite")
    g_max = max(v.abs().max().item() for v in g_p.values())
    worst, worst_name = 0.0, None
    for name, want in g_p.items():
        err = (g_k[name] - want).abs().max().item()
        ratio = err / (GRAD_RTOL * want.abs().max().item() + GRAD_FLOOR * g_max)
        if ratio > worst:
            worst, worst_name = ratio, name
    d_norm = torch.sqrt(sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p)).item()
    norm = torch.sqrt(sum((v ** 2).sum() for v in g_p.values())).item()
    print(f"  {config['mode']} B={B} full-width gradients, kernel vs plain: {len(g_p)} "
          f"tensors, launches "
          f"{counts}; worst tensor at {worst:.3f} of its tolerance ({worst_name}); "
          f"global norm {norm:.6e}, |diff| {d_norm:.3e} ({d_norm / norm:.3e} relative)",
          flush=True)
    check(worst <= 1.0, f"gradient of {worst_name} disagrees with the plain path")
    check(d_norm <= GRAD_NORM_RTOL * norm, "global gradient disagrees with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()


def write_corpus(root: str, channels: int = 1):
    """wsj0 layout: TRAIN_FILES `tr` and VALID_FILES `cv` pairs of FILE_S
    seconds, of `channels` channels; a corpus already there is kept."""
    if os.path.isdir(root):
        return
    rng = np.random.default_rng(1)
    for sub, n in (("tr", TRAIN_FILES), ("cv", VALID_FILES)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, sub, kind))
        for i in range(n):
            clean = (synth_wav(FILE_S, i, rng) if channels == 1
                     else synth_waves(FILE_S, i, rng, channels))
            noisy = clean + 0.1 * rng.standard_normal(clean.shape).astype(np.float32)
            save_wav(os.path.join(root, sub, "clean", f"u{i:03d}.wav"), clean, SR)
            save_wav(os.path.join(root, sub, "noisy", f"u{i:03d}.wav"), noisy, SR)


def eval_forwards(eval_n: int, files: int = VALID_FILES,
                  mode: str = "regen-joint-training") -> int:
    """NCSN++ forwards of one in-training evaluation of `files` validation
    files of FILE_S (one bucket), per chunk of 8 rows, at the model's
    enhance defaults: StoRM's denoiser and N score forwards (no corrector),
    the score model's N x 2 (ald), the denoiser's one, the distilled
    student's two (the denoiser and the student)."""
    per_chunk = {"score-only": 2 * eval_n, "denoiser-only": 1, "distill": 2}.get(mode, 1 + eval_n)
    return -(-files // 8) * per_chunk


# the serving --mode of a trainable mode's checkpoint
SERVING_MODE = {"regen-joint-training": "storm", "regen-freeze-denoiser": "storm",
                "score-only": "score-only", "denoiser-only": "denoiser-only",
                "distill": "distill"}


@functools.lru_cache(maxsize=None)
def single_net_structure(mode: str) -> NCSNpp:
    """The full-width net of the score-only or denoiser-only model, for its
    module list only."""
    return (NCSNpp(input_channels=4) if mode == "score-only"
            else NCSNpp(input_channels=2, discriminative=True))


def step_launches(mode: str, teacher_forwards: int = 0, structure=None):
    """(forward, backward) upfirdn2d launches of one training step of `mode`,
    read from the nets' module lists (`k1_of_module`): every call of each
    net's forward, and a backward for each call whose input needs a
    gradient, which is every call but the input pyramid's downsamplings
    (one per Combine module) of a net whose input holds no parameter's
    output: StoRM's denoiser and the one net of score-only and
    denoiser-only. StoRM's score net reads D(Y), so all its calls have one.
    A distill step runs the denoiser, the teacher's `teacher_forwards` score
    forwards and the student, all without a graph but the student, whose
    input holds no parameter's output (D(Y) is computed without one).
    `structure`: the nets, (denoiser, score net) or (net,), where they are
    not the default NCSN++ (an ncsnpplarge score net, ConvTasNet)."""
    if mode == "distill":
        den, score = storm_structure()
        k1 = [k1_of_module(score, i) for i in range(len(score.all_modules))]
        fwd = sum(k1_of_module(den, i) for i in range(len(den.all_modules)))
        bwd = sum(n for i, n in enumerate(k1) if not isinstance(score.all_modules[i], Combine))
        return fwd + (teacher_forwards + 1) * sum(k1), bwd
    if structure is not None:
        nets = list(zip(structure, (False, True)))
    elif mode in SERVING_MODE and SERVING_MODE[mode] != "storm":
        nets = [(single_net_structure(mode), False)]
    else:
        den, score = storm_structure()
        nets = [(den, False), (score, True)]
    fwd = bwd = 0
    for net, input_grad in nets:
        calls = {i: k1_of_module(net, i) for i in range(len(getattr(net, "all_modules", ())))}
        fwd += sum(calls.values())
        bwd += sum(n for i, n in calls.items()
                   if input_grad or not isinstance(net.all_modules[i], Combine))
    return fwd, bwd


def pesq_available() -> bool:
    try:
        import pesq  # noqa: F401
    except ImportError:
        return False
    return True


def phase_train(workdir: str, dtype: str = "float32", steps_total: int = TRAIN_STEPS,
                eval_files: int = 0, eval_n: int = 30, mode: str = "regen-joint-training",
                extra=(), tag=None, structure=None):
    """The training path through `python -m storm_tpu_torch.train --mode
    mode` (and `extra` flags) in `dtype` on the corpus in `workdir/corpus`
    (written once), with an in-training evaluation of `eval_files`
    validation files at N=`eval_n` after every epoch. `structure`: the
    nets where they are not the default NCSN++ (`step_launches`). Returns a
    dict of its launch counts and step figures, and its checkpoint
    directory."""
    if tag is None:
        tag = "_".join([mode] + [e.lstrip("-") for e in extra]) + "_" if (
            mode != "regen-joint-training" or extra) else ""
    corpus = os.path.join(workdir, "corpus")
    logs = os.path.join(workdir, f"logs_{tag}{dtype}_{eval_files}")
    write_corpus(corpus)
    step_fwd, step_bwd = step_launches(mode, DISTILL_TEACHER_FORWARDS, structure)
    steps, first_params, dtypes, runs = [], {}, set(), []
    original, launch = train_graphs.TrainPrograms.step, kup._launch

    def timed_step(programs, arrays, generator):
        """The loop's step (`TrainPrograms.step`: the eager first call, the
        warm-up and capture, then replays) between two CUDA events; adds no
        host sync to the loop. The allocator's peak is read on the host after
        each step's enqueue; the loss is kept as a copy (a replay's output is
        overwritten by the next)."""
        if not first_params:
            runs.append(programs)
            first_params.update({k: v.detach().clone()
                                 for k, v in programs.model.state_dict().items()})
        before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aux = original(programs, arrays, generator)
        end.record()
        steps.append(dict(start=start, end=end, loss=aux["loss"].clone(),
                          peak=torch.cuda.max_memory_allocated(),
                          launches=(kup.upfirdn2d_cuda.launches - before[0],
                                    kup.upfirdn2d_bwd_cuda.launches - before[1])))
        return aux

    def watched_launch(x, *args):
        dtypes.add(x.dtype)
        return launch(x, *args)

    # the loss is logged at the last step of each epoch only, where the epoch's
    # mean reads it back anyway: the loop keeps its own host syncs and no more
    epoch_len = TRAIN_FILES // TRAIN_B
    argv = ["--mode", mode, *extra, "--base_dir", corpus, "--format", "wsj0",
            "--batch_size", str(TRAIN_B), "--num_frames", str(TRAIN_FRAMES),
            "--max_steps", str(steps_total), "--num_eval_files", str(eval_files),
            "--eval_N", str(eval_n), "--log_dir", logs, "--log_every_n_steps", str(epoch_len),
            "--num_workers", "4", "--seed", "0", "--dtype", dtype, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    replays, real_replay = [], graphs.Program.replay

    def replay(prog):
        replays.append(prog.key)
        return real_replay(prog)

    t0 = time.perf_counter()
    with mock.patch.object(train_graphs.TrainPrograms, "step", timed_step), \
            mock.patch.object(kup, "_launch", watched_launch), calls_counted() as eval_calls, \
            mock.patch.object(graphs.Program, "replay", replay):
        _, text = captured(train.main, argv)
    wall = time.perf_counter() - t0
    launches = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    want_dtype = {"float32": torch.float32, "bfloat16": BF16}[dtype]
    want_dtypes = {want_dtype} if step_fwd else set()  # a time-domain net calls no K1
    check(dtypes == want_dtypes, f"{dtype} training launched upfirdn2d on {dtypes}")

    (run,) = os.listdir(logs)
    rows = [json.loads(line) for line in open(os.path.join(logs, run, "metrics.jsonl"))]
    losses = [s["loss"].item() for s in steps]
    logged = [r["step"] for r in rows if "train_loss" in r]
    epochs = [r for r in rows if "valid_loss" in r]
    valid = [r["valid_loss"] for r in epochs]
    check(len(steps) == steps_total, f"{len(steps)} steps, expected {steps_total}")
    check(logged == list(range(epoch_len, steps_total + 1, epoch_len)),
          f"train losses logged at steps {logged}")
    check(len(valid) == steps_total // epoch_len, f"{len(valid)} validations")
    # the evaluation's programs: the eager loop in the first epoch, captured in
    # the second, replayed after it with that epoch's EMA weights swapped in
    per_epoch = len(eval_calls) // max(len(valid), 1)
    check(len(replays) == max(0, len(eval_calls) - 2 * per_epoch),
          f"the evaluation made {len(eval_calls)} calls over {len(valid)} epochs and "
          f"{len(replays)} replays")
    # the trainer's programs: the step's from its third call, the validation
    # batch's (one per epoch here) from the third epoch
    (programs,) = runs
    st = programs.stats
    check("training steps and validation: graph" in text
          and st["captures"] == 1 + (len(valid) >= 2)
          and st["replays"] == steps_total - 2 + max(0, len(valid) - 2),
          f"the trainer's programs: {st}")
    evaluated = ("ValidationSISDR", "ValidationESTOI")
    quality = evaluated if eval_files else ()
    check(all(np.isfinite(losses))
          and all(np.isfinite(v) for r in rows for k, v in r.items()
                  if k != "step" and not k.startswith("Validation")),
          "a training or validation loss is not finite")
    check(all(set(r) >= {"ValidationPESQ", *evaluated} for r in epochs),
          "an epoch's metrics lack the reference's keys")
    check(all(np.isfinite(r[k]) for r in epochs for k in quality)
          and "eval failed" not in text,
          f"the in-training evaluation gave {[{k: r[k] for k in evaluated} for r in epochs]}")
    if eval_files:
        check(all(np.isfinite(r["ValidationPESQ"]) == pesq_available() for r in epochs),
              "ValidationPESQ is finite exactly when the pesq package imports")
    check(all(s["launches"] == (step_fwd, step_bwd) for s in steps),
          f"launches per step {[s['launches'] for s in steps]}, expected {(step_fwd, step_bwd)}")
    n_valid_fwd = step_fwd * len(valid) * -(-VALID_FILES // TRAIN_B)  # no backward
    n_eval_fwd = (K1_PER_FORWARD * len(valid) * eval_forwards(eval_n, eval_files, mode)
                  if eval_files else 0)
    check(launches == (step_fwd * steps_total + n_valid_fwd + n_eval_fwd,
                       step_bwd * steps_total),
          f"training launched {launches}")
    ckpt_dir = os.path.join(logs, run, "checkpoints")
    want_ckpts = ["best_loss.pt", "best_pesq.pt", "last.pt"] if eval_files else [
        "best_loss.pt", "last.pt"]
    check(sorted(os.listdir(ckpt_dir)) == want_ckpts, f"checkpoints {os.listdir(ckpt_dir)}")
    last = load_training_checkpoint(os.path.join(ckpt_dir, "last.pt"))
    check(last["step"] == steps_total, f"last.pt at step {last['step']}")
    check(last["config"]["dtype"] == dtype, f"last.pt's config has dtype {last['config']['dtype']}")
    if eval_files:
        metric = "pesq" if pesq_available() else "estoi"
        meta = load_training_checkpoint(os.path.join(ckpt_dir, "best_pesq.pt"))["meta"]
        check(meta["quality_metric"] == metric and np.isfinite(meta["best_quality"]),
              f"best_pesq.pt's meta {meta}")
    moved = [k for k, v in last["params"].items() if not torch.equal(v, first_params[k].cpu())]
    ema_moved = [k for k in moved if not torch.equal(last["ema_params"][k], first_params[k].cpu())]
    trained = list(first_params)
    if mode == "distill":  # the denoiser stays the teacher's, bit for bit
        trained = [k for k in first_params if not k.startswith("denoiser_net.")]
        check(not any(k.startswith("denoiser_net.") for k in moved),
              "the distilled student's denoiser moved")
    check(len(moved) > 0.9 * len(trained) and len(ema_moved) == len(moved),
          f"{len(moved)} of {len(trained)} tensors moved, {len(ema_moved)} in the EMA")

    # step time on the card's clock: the loop's period between the ends of
    # consecutive steps of one epoch (data loading included), and one
    # step's call from its first launch to its last kernel's end; from the
    # third step on, each is a replay of the step's program
    periods = [steps[i - 1]["end"].elapsed_time(steps[i]["end"])
               for i in range(2, len(steps)) if i % epoch_len]
    calls = [s["start"].elapsed_time(s["end"]) for s in steps[2:]]
    first_s = steps[0]["start"].elapsed_time(steps[0]["end"]) / 1e3
    second_s = steps[1]["start"].elapsed_time(steps[1]["end"]) / 1e3
    step_ms = statistics.median(periods)
    step_peak = max(s["peak"] for s in steps)
    r = dict(launches=launches, step_ms=step_ms, audio_s_per_s=TRAIN_B * TRAIN_AUDIO_S
             / (step_ms / 1e3), peak_gib=peak / 2**30, step_peak_gib=step_peak / 2**30,
             reserved_gib=reserved / 2**30, capture_s=st["capture_s"],
             pool_gib=st["pool_bytes"] / 2**30,
             eval={k: [r[k] for r in epochs] for k in ("ValidationPESQ", *evaluated)},
             ckpt_dir=ckpt_dir, run=run, losses=losses)
    print(f"  {tag}{dtype}: trained {steps_total} steps at B={TRAIN_B} x {TRAIN_FRAMES} frames in "
          f"{wall:.1f} s wall (setup, validation, evaluation and checkpoints included); losses "
          f"{[round(v, 2) for v in losses]}; valid {[round(v, 2) for v in valid]}", flush=True)
    print(f"  {tag}{dtype} step (a replay of its program): {step_ms:.2f} ms median period "
          f"{[round(p, 2) for p in periods]} (first step, eager, {first_s:.3f} s; second, the "
          f"warm-up and capture, {second_s:.3f} s; a replayed step's call alone median "
          f"{statistics.median(calls):.2f} ms); {r['audio_s_per_s']:.3f} audio s trained per s; "
          f"peak memory {r['peak_gib']:.2f} GiB allocated (of the training steps "
          f"{r['step_peak_gib']:.2f} GiB), {r['reserved_gib']:.2f} GiB reserved; the trainer's "
          f"programs: {st['captures']} captures in {st['capture_s']:.2f} s, {st['replays']} "
          f"replays, a pool of {r['pool_gib']:.2f} GiB (reserved before the last warm-up "
          f"{st['reserved_before_warm_up'] / 2**30:.2f} GiB, before the last capture "
          f"{st['reserved_before_capture'] / 2**30:.2f} GiB); launches per step "
          f"{steps[-1]['launches']}, in all {launches}; {len(moved)} of {len(first_params)} "
          f"tensors moved", flush=True)
    if eval_files:
        print(f"  {tag}{dtype} evaluation of {eval_files} files at N={eval_n} per epoch: "
              + "; ".join(f"{k} {[round(v, 4) for v in vals]}" for k, vals in r["eval"].items())
              + f"; best_pesq.pt by {meta['quality_metric']} ({meta['best_quality']:.4f}); "
              f"{len(eval_calls)} enhancer calls, {len(replays)} graph replays", flush=True)

    # the written checkpoint serves, in the dtype its config names
    noisy = os.path.join(workdir, "noisy_one")
    out = os.path.join(workdir, f"enhanced_one_{tag}{dtype}_{eval_files}")
    if not os.path.isdir(noisy):
        os.makedirs(noisy)
        save_wav(os.path.join(noisy, "one.wav"), synth_wav(1.0, 3, np.random.default_rng(2)), SR)
    x, _ = load_wav(os.path.join(noisy, "one.wav"))
    dtypes.clear()
    best = "best_pesq" if eval_files else "last"
    with mock.patch.object(kup, "_launch", watched_launch):
        enhancement.main(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt",
                          os.path.join(ckpt_dir, f"{best}.pt"), "--mode", SERVING_MODE[mode],
                          "--N", "2", "--dtype", "checkpoint", "--device", "cuda"])
    y, sr = load_wav(os.path.join(out, "one.wav"))
    check(sr == SR and y.shape == x.shape and bool(np.isfinite(y).all()),
          f"enhancing with the trained checkpoint gave {y.shape}")
    check(dtypes == want_dtypes, f"the {dtype} checkpoint enhanced in {dtypes}")
    print(f"  the trained checkpoint ({best}.pt) enhanced a {x.shape[-1] / SR:.1f} s file at "
          f"N=2 in {dtype} (--dtype checkpoint, --mode {SERVING_MODE[mode]})", flush=True)
    return r


# profile groups: label -> (kernel-name stems, the launch counter of the
# wrapper that launches them, or None for a library's kernels)
K1_GROUPS = {"upfirdn2d (K1) down config": (("upfirdn2d_down",), "K1"),
             "upfirdn2d (K1) up config": (("upfirdn2d_up",), "K1")}
INT8_GROUPS = {**K1_GROUPS, "quantize_int8 (K3)": (("quantize_int8_kernel",), "K3"),
               "int8 GEMM (torch._int_mm)": (("gemm_s8", "imma", "i8i8", "s8s8"), None)}
LAUNCH_COUNTERS = {
    "K1": lambda: kup.upfirdn2d_cuda.launches + kup.upfirdn2d_bwd_cuda.launches,
    "K3": lambda: kq.quantize_int8_cuda.launches,
}


def print_profile(what: str, prof, wall_ms: float, groups, launched):
    """Device time by kernel from the trace's kernel events (`kernel_events`).
    The busy time is the union of the intervals; each kernel's share is of the
    summed kernel time. Also printed: the sum of key_averages' device time
    over every device row (annotations included), the annotation spans and
    the kernels that overlap, if any. `launched` holds {counter: launches in
    the traced window}. Fails if a group whose counter counted launches
    matches no device event (a renamed kernel would otherwise show 0 ms), or
    if a counter's groups together match fewer than PROFILE_MIN_MATCHED of
    its launches, or more."""
    from torch.autograd import DeviceType

    spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)]
    unique = kernel_events(prof)
    check(len(unique) > 0, "the profiler saw no device time")
    by_name = {}
    busy_us, end, end_name, overlaps = 0.0, -float("inf"), None, {}
    for start, stop, name, _ in unique:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (stop - start) / 1e3, n + 1)
        if start < end:
            pair = (end_name[:40], name[:40])
            overlaps[pair] = overlaps.get(pair, 0.0) + (min(stop, end) - start) / 1e3
        busy_us += max(0.0, stop - max(start, end))
        if stop > end:
            end, end_name = stop, name
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    summed_ms, busy_ms = sum(r[1] for r in rows), busy_us / 1e3
    averages_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
    span_ms = {}
    for e in spans:
        span_ms[e.name] = span_ms.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    print(f"  {what} under the profiler: wall {wall_ms:.1f} ms; {len(unique)} distinct kernel "
          f"events, {len({u[3] for u in unique})} stream ids; kernel time summed "
          f"{summed_ms:.1f} ms, device busy (union) {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall); key_averages' device time summed "
          f"{averages_ms:.1f} ms; annotation spans {sum(span_ms.values()):.1f} ms "
          f"{ {k[:40]: round(v, 2) for k, v in sorted(span_ms.items(), key=lambda kv: -kv[1])[:4]} }",
          flush=True)
    for (a, b), ms in sorted(overlaps.items(), key=lambda o: -o[1])[:5]:
        print(f"    overlap {ms:8.2f} ms: {a} | {b}")
    for key, ms, count in rows[:20]:
        print(f"    {100 * ms / summed_ms:5.1f}%  {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    matched = dict.fromkeys(launched, 0)
    for label, (keys, counter) in groups.items():
        sel = [r for r in rows if any(k in r[0] for k in keys)]
        ms, n = sum(r[1] for r in sel), sum(r[2] for r in sel)
        print(f"  {label}: {ms:.2f} ms in {n} launches ({100 * ms / summed_ms:.2f}% of kernel "
              f"time)", flush=True)
        if counter is not None:
            matched[counter] += n
            check(launched[counter] == 0 or n > 0,
                  f"{what}: {counter}'s wrapper counted {launched[counter]} launches, but no "
                  f"device event matches the group {label!r} ({keys})")
    for counter, n in launched.items():
        print(f"  {counter}: {matched[counter]} device events for {n} counted launches",
              flush=True)
        check(PROFILE_MIN_MATCHED * n <= matched[counter] <= n,
              f"{what}: {counter}'s groups match {matched[counter]} device events for {n} "
              f"counted launches")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, kernel_ms=summed_ms, events=matched)


def profile_run(what: str, fn, groups=K1_GROUPS):
    """Trace fn() with torch.profiler (after the caller's warm-up) and print
    where the device time went."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = {k: count() for k, count in LAUNCH_COUNTERS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: count() - before[k] for k, count in LAUNCH_COUNTERS.items()}
    return print_profile(what, prof, wall_ms, groups, launched)


def phase_profile_train(dtype: str = "float32", groups=K1_GROUPS):
    """Trace two full-width train steps (B=8, 256 x 256) in `dtype`."""
    model = build_model({"mode": "regen-joint-training", "dtype": dtype}, device="cuda",
                        seed=0).train()
    state = init_train_state(model, model.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    batch = (x, x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen))
    model.train_step(state, batch, gen)  # warm-up at the same shapes

    def two_steps():
        for _ in range(2):
            model.train_step(state, batch, gen)

    profile_run(f"two {dtype} train steps (B={TRAIN_B}, {FREQS} x {TRAIN_FRAMES})", two_steps,
                groups)


def phase_profile():
    """Trace one enhancement of the longest file (CLI defaults) and print where
    the device time goes."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald")  # warm-up at the same shapes
    profile_run(f"enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=DEFAULT_N, corrector="ald"))


# --- int8 serving (phases 10, 11, 13) and fused_leaky_relu (phase 12)


def f32_ties(inv: float) -> np.ndarray:
    """float32 values x with x * inv (a float32 product) exactly k + 0.5, for
    k in [-130, 130) where such an x exists."""
    inv32 = np.float32(inv)
    want = (np.arange(-130, 130) + 0.5).astype(np.float32)
    base = (want.astype(np.float64) / float(inv32)).astype(np.float32)
    found = [c[(c * inv32) == want]
             for c in (base, np.nextafter(base, np.float32(np.inf)),
                       np.nextafter(base, np.float32(-np.inf)))]
    return np.unique(np.concatenate(found))


def bf16_ties(inv: float) -> np.ndarray:
    """Every bfloat16 value (as float32) whose float32 product with inv is
    exactly k + 0.5, |k + 0.5| < 130."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < np.float32(130 / inv))]
    v = x * np.float32(inv)
    return x[v - np.floor(v) == 0.5]


def bf16_product_ties(inv: float) -> np.ndarray:
    """Every bfloat16 value (as float32) whose product with bf16(inv),
    rounded to bfloat16, is exactly k + 0.5, |k + 0.5| < 130, where its
    float32 product with inv is not: the bfloat16-product mode's ties, at
    which the two modes' codes part."""
    inv_b = np.float32(torch.tensor(np.float32(inv)).bfloat16().item())
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < np.float32(130 / inv))]
    p = torch.from_numpy(x * inv_b).bfloat16().float().numpy()  # x * inv_b is exact
    f = x * np.float32(inv)
    return x[(p - np.floor(p) == 0.5) & (f - np.floor(f) != 0.5)]


def with_ties(x: torch.Tensor, inv: float, product: torch.dtype = torch.float32) -> int:
    """Write exact .5 ties of the product in `product` (tiled over the first
    elements) and values beyond +-127 (the last ones) into x in place;
    returns the count of ties."""
    if product == torch.bfloat16:
        ties = bf16_product_ties(inv)
    else:
        ties = bf16_ties(inv) if x.dtype == torch.bfloat16 else f32_ties(inv)
    flat = x.view(-1)
    n = min(len(ties) * 64, flat.numel() // 2)
    if n:
        flat[:n] = torch.from_numpy(np.resize(ties, n)).to(flat)
    sat = np.array([200, -200, 1e4, -1e4, 127.49, -127.6], np.float32) / np.float32(inv)
    flat[-len(sat):] = torch.from_numpy(sat).to(flat)
    return n


def check_codes(what: str, x: torch.Tensor, inv: float,
                product: torch.dtype = torch.float32) -> int:
    """Hold the kernel's codes to plain's, exactly; returns max |got - want|."""
    got, want = kq.quantize_int8_cuda(x, inv, product), kq.quantize_int8_plain(x, inv, product)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    differ, err = int((diff != 0).sum().item()), int(diff.max().item())
    check(differ == 0, f"quantize_int8 {what}: {differ} codes differ from plain, by up to {err}")
    return err


def k3_bound_ms(x: torch.Tensor):
    """(bytes bound, operations bound) in ms: the input and one byte per
    element once over the memory rate; multiply, round and clip (3 ops) per
    element over the f32 peak."""
    return ((x.element_size() + 1) * x.numel() / PEAK_BYTES_PER_S * 1e3,
            3.0 * x.numel() / PEAK_F32_FLOP_PER_S * 1e3)


def phase_quantizer_vs_plain(workdir: str, gen: torch.Generator):
    """K3 at every quantized-conv input of the 4 s request, and at the probe's
    shape. Returns ({input shape: times}, the score forward's shapes, probe,
    the largest |kernel code - plain code| over every input)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    name = f"utt{len(SECONDS) - 1}_{SECONDS[-1]:.1f}s.wav"
    y = bucketed(load_wav(os.path.join(workdir, "noisy", name))[0])
    quant = quant_mod.calibrate_storm(model, y, N=CALIB_N, min_channels=QUANT_MIN_CHANNELS,
                                      generator=torch.Generator(device="cuda").manual_seed(1))
    check(n_quantized(quant) == 2 * N_QUANT,
          f"{n_quantized(quant)} convs quantized, expected {2 * N_QUANT}")
    calls = []  # (net, input, inv) of every quantized conv call of one forward per net

    def capture(net):
        def hook(mod, inp, out):
            if mod.a_scale is not None:
                calls.append((net, inp[0].clone(), qconv.activation_inverse(mod.a_scale)))
        return hook

    hooks = [m.register_forward_hook(capture(net))
             for net in ("denoiser", "score")
             for m in qconv.quantizable_convs(getattr(model, f"{net}_net")).values()]
    try:
        with torch.inference_mode():
            model.enhance(y, N=1, corrector="none", quant=quant)  # one forward of each net
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == 2 * N_QUANT, f"{len(calls)} quantized conv calls, expected {2 * N_QUANT}")
    per_shape, launch, score_shapes, ties, max_err = {}, {}, [], 0, 0
    with torch.inference_mode():  # the captured inputs are inference tensors
        for net, x, inv in calls:
            shape = tuple(x.shape)
            ties += with_ties(x, inv)
            max_err = max(max_err, check_codes(f"{net} {shape}", x, inv))
            if net != "score":
                continue
            score_shapes.append(shape)
            if shape not in per_shape:
                bytes_ms, ops_ms = k3_bound_ms(x)
                per_shape[shape] = dict(
                    ms=time_ms(lambda: kq.quantize_int8_cuda(x, inv)),
                    plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, inv), reps=5),
                    bytes_ms=bytes_ms, ops_ms=ops_ms, calls=0)
                launch[shape] = functools.partial(kq.quantize_int8_cuda, x, inv)
            per_shape[shape]["calls"] += 1
        for shape, dev in zip(launch, device_ms(list(launch.values()), "quantize_int8_kernel")):
            per_shape[shape]["device_ms"] = dev
    del calls, launch
    print(f"  {2 * N_QUANT} quantized conv inputs (f32), {ties} exact ties written in: codes "
          f"identical to plain", flush=True)
    for shape, r in per_shape.items():
        print(f"  quantize_int8 f32 {shape} x{r['calls']} per score forward: ms={r['ms']:.5f} "
              f"device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} (bytes) "
              f"ratio={r['ms'] / r['bytes_ms']:.2f} device/bound="
              f"{r['device_ms'] / r['bytes_ms']:.2f}", flush=True)

    x = (10.0 * torch.randn(PROBE_SHAPE, device="cuda", generator=gen)).to(torch.bfloat16)
    probe_ties = with_ties(x, PROBE_S)
    max_err = max(max_err, check_codes(f"probe {PROBE_SHAPE} bf16", x, PROBE_S))
    bytes_ms, ops_ms = k3_bound_ms(x)
    probe = dict(shape=PROBE_SHAPE, dtype="bfloat16", s=PROBE_S, ties=probe_ties,
                 ms=time_ms(lambda: kq.quantize_int8_cuda(x, PROBE_S)),
                 plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, PROBE_S), reps=5),
                 bound_ms=max(bytes_ms, ops_ms))
    half = x[: PROBE_SHAPE[0] // 16].clone()  # bf16 ties exist at s = 2
    two_ties = with_ties(half, 2.0)
    check(two_ties > 0, "no bf16 tie at s = 2")
    max_err = max(max_err, check_codes("bf16 at s = 2", half, 2.0))
    print(f"  probe {PROBE_SHAPE} bf16 s={PROBE_S} ({probe_ties} exact ties): "
          f"ms={probe['ms']:.5f} plain_ms={probe['plain_ms']:.5f} "
          f"bound_ms={probe['bound_ms']:.5f} (bytes); bf16 at s=2 with {two_ties} ties: codes "
          f"identical; max |kernel code - plain code| over all {2 * N_QUANT + 2} inputs: "
          f"{max_err}", flush=True)
    return per_shape, score_shapes, probe, max_err


def phase_int8_path(workdir: str, f32_rtf, lengths):
    """`python -m storm_tpu_torch.enhancement --quant int8` twice on phase 5's
    checkpoint and files; then the int8 path against the plain quantizer and
    against float32. Returns the first run's quantizer launches."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced_int8")
    cache = scale_cache_path(ckpt)
    argv = ["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt, "--mode", "storm",
            "--timeit", "--device", "cuda", "--N", str(N_STEPS), "--quant", "int8",
            "--quant_min_channels", str(QUANT_MIN_CHANNELS)]
    runs = []
    for run in (1, 2):
        kq.quantize_int8_cuda.launches = kup.upfirdn2d_cuda.launches = 0
        t0 = time.perf_counter()
        with calls_counted() as per_call:
            text = run_enhancement(argv)
        wall = time.perf_counter() - t0
        per_file = [(k3, k1) for k1, k3, _ in per_call]
        totals = (kq.quantize_int8_cuda.launches, kup.upfirdn2d_cuda.launches)
        check_outputs(out, lengths)
        calibrated = 1 if run == 1 else 0
        if run == 1:
            check(f"int8 calibration done ({2 * N_QUANT} convs quantized; scales saved to "
                  f"{cache})" in text and os.path.exists(cache), "run 1 did not calibrate")
        else:
            check(f"int8 scales loaded from {cache} ({2 * N_QUANT} convs quantized" in text,
                  "run 2 did not load the cached scales")
        check(per_file == [(K3_PER_FILE, 18 * NFE)] * len(SECONDS),
              f"run {run}: launches per file {per_file}, expected "
              f"{(K3_PER_FILE, 18 * NFE)} for each of {len(SECONDS)}")
        check(totals == (K3_PER_FILE * len(SECONDS),
                         18 * (NFE * len(SECONDS) + calibrated * CALIB_FORWARDS)),
              f"run {run}: launches {totals}")
        runs.append(dict(rtf=rtf_of(text), totals=totals, wall=wall))
        print(f"  run {run}: {wall:.2f} s wall; quantizer launches {totals[0]} "
              f"({K3_PER_FILE} per file), upfirdn2d {totals[1]} (18 x {NFE} per file"
              f"{f' + 18 x {CALIB_FORWARDS} calibration forwards' if calibrated else ''})",
              flush=True)

    # the same files and noise, direct: int8 through the kernel, int8 with
    # the plain quantizer (4 s file), float32; cuDNN deterministic
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    quant = quant_mod.load_scales(cache)
    torch.backends.cudnn.deterministic = True
    try:
        for name in lengths:
            y = bucketed(load_wav(os.path.join(noisy, name))[0])

            def enhance(**kw):
                gen = torch.Generator(device="cuda").manual_seed(0)
                return model.enhance(y, N=DEPTH_N, corrector="ald", generator=gen, **kw)[0]

            x8, x32 = enhance(quant=quant), enhance()
            check(bool(torch.isfinite(x8).all()), f"{name}: int8 output not finite")
            scale = x32.abs().max().item()
            rel = (x8 - x32).abs().max().item() / scale
            line = (f"  {name}: RTF f32 {f32_rtf[name]:.4f} (phase 5), int8 "
                    f"{runs[0]['rtf'][name]:.4f} / {runs[1]['rtf'][name]:.4f} (runs 1 / 2); "
                    f"at N={DEPTH_N}: max|int8 - f32| / max|f32| = {rel:.4e}")
            if name == max(lengths, key=lengths.get):
                with mock.patch.object(qconv, "quantize_int8", kq.quantize_int8_plain):
                    xp = enhance(quant=quant)
                err, s8 = (x8 - xp).abs().max().item(), xp.abs().max().item()
                line += f"; kernel vs plain quantizer max abs err {err:.3e} (scale {s8:.3e})"
                check(err <= 1e-6 * s8, f"{name}: int8 path with the kernel disagrees with the "
                                        f"plain quantizer ({err:.3e})")
            print(line, flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    return runs[0]["totals"][0]


def phase_fused_act(gen: torch.Generator):
    """K2 through its op API, forward and gradient, against autograd of plain."""
    inputs = [tuple(torch.randn(shape if i != 1 else shape[-1:], device="cuda", generator=gen)
                    for i in range(3)) for shape in K2_SHAPES]
    kfa.fused_leaky_relu_cuda.launches = 0
    results = []
    for x, b, g in inputs:
        xk, bk = x.clone().requires_grad_(), b.clone().requires_grad_()
        out = kfa.fused_leaky_relu(xk, bk)
        results.append((out.detach(), *torch.autograd.grad(out, (xk, bk), g)))
    torch.cuda.synchronize()
    launches = kfa.fused_leaky_relu_cuda.launches
    check(launches == len(K2_SHAPES), f"fused_leaky_relu launched {launches} times")
    max_err = 0.0
    for (x, b, g), (out, gx, gb) in zip(inputs, results):
        xp, bp = x.clone().requires_grad_(), b.clone().requires_grad_()
        want = kfa.fused_leaky_relu_plain(xp, bp)
        hx, hb = torch.autograd.grad(want, (xp, bp), g)
        what = f"fused_leaky_relu {tuple(x.shape)}"
        errs = []
        # the forward at atol = rtol = 1e-6; both gradients exactly: the
        # backward is autograd's own arithmetic on the kernel's mask
        for part, got, ref, exact in (("forward", out, want.detach(), False),
                                      ("grad x", gx, hx, True), ("grad bias", gb, hb, True)):
            errs.append((got - ref).abs().max().item())
            ok = torch.equal(got, ref) if exact else torch.allclose(got, ref, atol=1e-6, rtol=1e-6)
            check(ok, f"{what} {part}: max abs err {errs[-1]:.3e}"
                      f"{' (must be 0)' if exact else ''}")
        max_err = max(max_err, *errs)
        print(f"  {what}: max abs err forward {errs[0]:.2e}, grad x {errs[1]:.2e}, grad bias "
              f"{errs[2]:.2e} (largest grad bias {hb.abs().max().item():.3e})", flush=True)
    x, b, _ = inputs[0]
    n = x.numel()
    bytes_ms = (8.0 * n + 4.0 * b.numel()) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4.0 * n / PEAK_F32_FLOP_PER_S * 1e3
    with torch.no_grad():
        r = dict(ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b)),
                 device_ms=device_ms([lambda: kfa.fused_leaky_relu_cuda(x, b)],
                                     "fused_leaky_relu_kernel")[0],
                 mask_ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b, with_mask=True)),
                 plain_ms=time_ms(lambda: kfa.fused_leaky_relu_plain(x, b), reps=5),
                 bytes_ms=bytes_ms, ops_ms=ops_ms, launches=launches, max_abs_err=max_err)
    print(f"  fused_leaky_relu {tuple(x.shape)}: ms={r['ms']:.5f} device_ms={r['device_ms']:.5f} "
          f"(with the mask "
          f"{r['mask_ms']:.5f}) plain_ms={r['plain_ms']:.5f} bound_ms={max(bytes_ms, ops_ms):.5f} "
          f"(bytes; 9 B per element with the mask: "
          f"{9.0 * n / PEAK_BYTES_PER_S * 1e3:.5f})", flush=True)
    return r


def phase_profile_int8(workdir: str):
    """Trace one int8 enhancement of the 4 s file (CLI defaults)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    quant = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald", quant=quant)  # warm-up at the same shapes
    profile_run(f"int8 enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=DEFAULT_N, corrector="ald", quant=quant), INT8_GROUPS)


# --- serving at batch > 1 (phases 14-17)

# the batched CLI: two buckets of four files, 1 s (16384 samples, 192 frames)
# and 4 s (65536 samples, 576 frames), 19.6 s of audio
CLI_BATCH, BATCH_SECONDS = 4, (1.0, 1.0, 1.01, 1.02, 3.7, 3.85, 4.0, 4.0)
INVARIANCE_N = 5
# reverse steps of the phases cut in depth to keep the script near 600 s:
# the batched CLI (14, 19), phase 11's direct int8 comparisons, phase 35's
# trajectory and phase 41's score-only CLI; their launch counts follow N
DEPTH_N = 4
DEPTH_NFE = 1 + 2 * DEPTH_N
# the server and streaming runs use N=3 (7 NFE) to stay within time
SERVE_N = 3
SERVE_NFE = 1 + 2 * SERVE_N
SERVE_BATCH, SERVE_CLIENTS, INT8_REQUESTS = 4, 8, 8
SERVE_SECONDS = (1.0, 3.6, 1.0, 3.7, 1.01, 3.8, 1.02, 3.9, 1.0, 4.0, 1.015, 4.0)
# the servers warm the 4 s bucket's row sizes only (each capture empties the allocator's
# cache first): a batch of 1 s requests runs the eager loop at its shape's first call
SERVE_WARMUP = "4.0"
STREAM_S, STREAM_CHUNK_S, STREAM_OVERLAP_S, STREAM_ROWS = 12.0, 2.0, 0.5, 8
K1_PER_FORWARD = len(k1_calls(6))  # 18 upfirdn2d calls per NCSN++ forward


@contextlib.contextmanager
def shapes_recorded():
    """While active, every upfirdn2d call of NCSN++ (nn/resample.py) adds its
    (config, B, C, H, W, dtype) to the first yielded set and every activation
    quantizer call (nn/qconv.py) its (input shape, dtype, product dtype) to
    the second; the calls run as before (threads included)."""
    k1, k3 = set(), set()

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
        k1.add((config_of(up, down, pad), *x.shape, x.dtype))
        return kup.upfirdn2d(x, kernel, up=up, down=down, pad=pad)

    def quantize_int8(x, inv, product=torch.float32):
        k3.add((tuple(x.shape), x.dtype, product))
        return kq.quantize_int8(x, inv, product)

    with mock.patch.object(resample, "upfirdn2d", upfirdn2d), \
            mock.patch.object(qconv, "quantize_int8", quantize_int8):
        yield k1, k3


@contextlib.contextmanager
def adjoint_shapes_recorded():
    """While active, every backward of `UpFirDn2d` (kernels/upfirdn.py) adds
    its forward's (config, B, C, H, W, gradient dtype) to the yielded set;
    the backward runs as before."""
    shapes, real = set(), kup.UpFirDn2d.backward

    def backward(ctx, g):
        _, up, down, pad, (H, W) = ctx.args
        shapes.add((config_of(up, down, pad), g.shape[0], g.shape[1], H, W, g.dtype))
        return real(ctx, g)

    with mock.patch.object(kup.UpFirDn2d, "backward", staticmethod(backward)):
        yield shapes


# the shapes (and K3 inputs) already held against plain in this run, with their error
K1_CHECKED, K3_CHECKED = {}, {}


def check_k1_at(what: str, shapes, gen) -> float:
    """upfirdn2d against plain (both FIRs) at every recorded shape, in its
    recorded dtype; a shape an earlier phase of this run checked keeps its
    error and is not checked again."""
    flips = {fir: n[1] for fir, n in BF16_FLIPS["upfirdn2d"].items()}
    new = [s for s in sorted(shapes, key=str) if s not in K1_CHECKED]
    for cfg, B, C, H, W, dtype in new:
        K1_CHECKED[(cfg, B, C, H, W, dtype)] = check_forward(
            cfg, torch.randn(B, C, H, W, device="cuda", generator=gen).to(dtype))
    errs = [K1_CHECKED[s] for s in shapes]
    tops = sorted({(B, W) for cfg, B, C, H, W, _ in shapes if cfg == "down" and H == FREQS})
    dtypes = sorted({str(s[-1]).split(".")[-1] for s in shapes})
    flips = {fir: n[1] - flips[fir] for fir, n in BF16_FLIPS["upfirdn2d"].items()}
    print(f"  upfirdn2d against plain at the {len(shapes)} shapes {what} gave it ({len(new)} "
          f"not checked before in this run; {dtypes}; "
          f"(B, W) at the top level: {tops}): max abs err {max(errs):.2e}"
          + (f"; bfloat16 elements that differ (by 1 ulp): {flips['ncsnpp']} with NCSN++'s "
             f"FIR, {flips['asym']} with the asymmetric one" if "bfloat16" in dtypes else ""),
          flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def check_k1_bwd_at(what: str, shapes, gen) -> float:
    """upfirdn2d's adjoint kernel against plain (both FIRs) at every recorded
    forward shape, in its recorded dtype, with `compare`'s allowance, as
    phase 24 holds it at a train step's B=8 shapes."""
    errs = []
    for cfg, B, C, H, W, dtype in sorted(shapes, key=str):
        c = CONFIGS[cfg]
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(B, C, Ho, Wo, device="cuda", generator=gen).to(dtype)
        for fir, kern in (("ncsnpp", c["kernel"]), ("asym", ASYM)):
            rest = (c["up"], c["down"], c["pad"], (H, W))
            errs.append(compare(f"upfirdn2d_bwd {cfg} {tuple(g.shape)} -> {H}x{W} {dtype}",
                                kup.upfirdn2d_bwd_cuda(g, kern, *rest),
                                kup.upfirdn2d_bwd_plain(g, kern, *rest), "upfirdn2d_bwd",
                                kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kern), *rest), fir))
    print(f"  upfirdn2d's adjoint against plain at the {len(shapes)} shapes {what} gave it "
          f"({sorted({str(s[-1]).split('.')[-1] for s in shapes})}; batch rows "
          f"{sorted({s[1] for s in shapes})}): max abs err {max(errs):.2e}", flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def check_k3_at(what: str, shapes, gen) -> int:
    """The quantizer's codes against plain at every recorded (input shape,
    dtype, product), ties of that product's mode and saturating values
    written in, s = 12.7; an input an earlier phase of this run checked
    keeps its error."""
    for shape, dtype, product in sorted(shapes, key=str):
        if (shape, dtype, product) in K3_CHECKED:
            continue
        x = (10.0 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
        with_ties(x, PROBE_S, product)
        K3_CHECKED[(shape, dtype, product)] = check_codes(
            f"{what} {shape} {dtype} product {product}", x, PROBE_S, product)
    err = max([K3_CHECKED[s] for s in shapes], default=0)
    print(f"  quantize_int8 codes identical to plain at the {len(shapes)} input shapes {what} "
          f"gave it (batch rows {sorted({s[0][0] for s in shapes})}; "
          f"{sorted({(str(d), str(p)) for _, d, p in shapes})})", flush=True)
    torch.cuda.empty_cache()
    return err


def write_named_wavs(directory: str, seconds, prefix: str, seed: int):
    """One synthesized file per entry of `seconds`; returns {name: samples}."""
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    lengths = {}
    for i, s in enumerate(seconds):
        name = f"{prefix}{i:02d}_{s:.3f}s.wav"
        x = synth_wav(s, i, rng)
        save_wav(os.path.join(directory, name), x, SR)
        lengths[name] = x.shape[-1]
    return lengths


class SlicedNoise:
    """A noise source handing out pre-drawn (B, F, T, 2) draws in order,
    rows `rows` of each."""

    def __init__(self, draws, rows):
        self.draws, self.rows, self.used = draws, rows, 0

    def __call__(self, shape):
        z = self.draws[self.used][self.rows]
        check(tuple(z.shape[:-1]) == tuple(shape), f"noise {tuple(z.shape)} for {shape}")
        self.used += 1
        return z


def phase_batch_invariance(model, ys: np.ndarray, gen: torch.Generator) -> float:
    """One batch with injected noise against each row enhanced alone with its
    rows of the same noise; returns the largest |row alone - row in batch| /
    max|row in batch|."""
    B, T = ys.shape
    enh = BucketedEnhancer(model, N=INVARIANCE_N, corrector="ald")
    draws = [torch.randn(B, FREQS, bucket_frames(T), 2, device="cuda", generator=gen) * 0.5 ** 0.5
             for _ in range(1 + 2 * INVARIANCE_N)]
    torch.backends.cudnn.deterministic = True
    try:
        x_all, _ = enh(ys, noise=SlicedNoise(draws, slice(None)))
        worst = 0.0
        for i in range(B):
            xi, _ = enh(ys[i: i + 1], noise=SlicedNoise(draws, slice(i, i + 1)))
            worst = max(worst, float(np.abs(xi[0] - x_all[i]).max() / np.abs(x_all[i]).max()))
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  batch invariance (B={B} at {bucket_frames(T)} frames, N={INVARIANCE_N}, injected "
          f"noise): max |row alone - row in batch| / max |row| = {worst:.3e}", flush=True)
    check(worst <= 1e-4, f"a row enhanced alone differs from its batch by {worst:.3e} (> 1e-4)")
    return worst


def phase_batched_cli(workdir: str, gen: torch.Generator):
    """Phase 14. Returns (upfirdn2d launches, the kernel's max error, the files'
    directory, {file: output})."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "batch_noisy"), os.path.join(workdir, "batch_enhanced")
    lengths = write_named_wavs(noisy, BATCH_SECONDS, "b", seed=3)
    buckets = {}
    for n in lengths.values():
        buckets[-(-n // BUCKET)] = buckets.get(-(-n // BUCKET), 0) + 1
    calls = sum(-(-k // CLI_BATCH) for k in buckets.values())
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    outputs = {}
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--batch", str(CLI_BATCH), "--N", str(DEPTH_N),
                                "--timeit", "--device", "cuda"], outputs)
    wall = time.perf_counter() - t0
    launches = kup.upfirdn2d_cuda.launches
    check_outputs(out, lengths)
    batches = [(int(k), int(nfe), float(rtf)) for k, nfe, rtf in
               re.findall(r"batch of (\d+): nfe=(\d+) rtf=([0-9.]+)", text)]
    check(len(batches) == calls and all(nfe == DEPTH_NFE for _, nfe, _ in batches),
          f"batch lines {batches}, expected {calls} of nfe {DEPTH_NFE}")
    expected = K1_PER_FORWARD * DEPTH_NFE * calls
    audio_s = sum(lengths.values()) / SR
    print(f"  {len(lengths)} files ({audio_s:.3f} s of audio) in {calls} calls of B={CLI_BATCH} "
          f"(buckets {sorted(b * BUCKET for b in buckets)} samples): {wall:.2f} s wall, "
          f"{audio_s / wall:.4f} audio s per wall s; RTF per batch {[b[2] for b in batches]}; "
          f"upfirdn2d launches {launches} (expected {K1_PER_FORWARD} x {DEPTH_NFE} x {calls} = "
          f"{expected})",
          flush=True)
    check(launches == expected, f"upfirdn2d launched {launches} times, expected {expected}")
    err = check_k1_at("the batched CLI", k1_shapes, gen)

    model = build_model(STORM_CONFIG, device="cuda", seed=0)  # the checkpoint's weights
    first = sorted(lengths)[:CLI_BATCH]  # the 1 s bucket
    padded = -(-max(lengths[f] for f in first) // BUCKET) * BUCKET
    ys = np.stack([np.pad(load_wav(os.path.join(noisy, f))[0][0], (0, padded - lengths[f]))
                   for f in first])
    phase_batch_invariance(model, ys, gen)
    del model
    torch.cuda.empty_cache()
    return launches, err, noisy, outputs


def serve_args(ckpt: str, *extra):
    return serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--port", "0", "--batch", str(SERVE_BATCH),
         "--N", str(SERVE_N), "--warmup_buckets", SERVE_WARMUP, "--device", "cuda", *extra])


def http_call(host, port, method, path, body=None):
    """(status, headers, payload, seconds) of one request on its own connection."""
    conn = http.client.HTTPConnection(host, port, timeout=900)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        r = conn.getresponse()
        payload = r.read()
        return r.status, dict(r.getheaders()), payload, time.perf_counter() - t0
    finally:
        conn.close()


def run_server(what: str, args, waves, nfe: int = SERVE_NFE):
    """Build the server in this process, send `waves` from SERVE_CLIENTS
    client threads, read /healthz and /stats, stop it; every reply's X-NFE
    must be `nfe`. Returns a dict of what was measured, with the kernels'
    launches from before the build (warm-up and calibration included) and
    the shapes the kernels were given."""
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, k3_shapes):
        t0 = time.perf_counter()
        (httpd, batcher), build_text = captured(serve.build_server, args)
        build_s = time.perf_counter() - t0
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = httpd.server_address[:2]
            health = json.loads(http_call(host, port, "GET", "/healthz")[2])
            bodies = [encode_wav_bytes(w, SR) for w in waves]
            with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                t0 = time.perf_counter()
                replies = list(pool.map(
                    lambda body: http_call(host, port, "POST", "/enhance", body), bodies))
                wall = time.perf_counter() - t0
            stats = json.loads(http_call(host, port, "GET", "/stats")[2])
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(timeout=60)
    torch.cuda.synchronize()
    check(not thread.is_alive(), f"{what}: the server thread did not stop")
    for (status, headers, payload, _), w in zip(replies, waves):
        check(status == 200, f"{what}: reply {status}: {payload[:300]!r}")
        x, sr = decode_wav_bytes(payload)
        check(sr == SR and x.shape == (1, w.shape[-1]) and bool(np.isfinite(x).all()),
              f"{what}: reply of shape {x.shape} for {w.shape[-1]} samples")
        check(int(headers["X-NFE"]) == nfe, f"{what}: X-NFE {headers['X-NFE']}")
    n = len(waves)
    check(stats["requests"] == n and stats["errors"] == 0 and stats["batched_requests"] == n,
          f"{what}: /stats {stats}")
    check(stats["batched_requests"] > stats["batches"], f"{what}: no batch of more than one row")
    latency = np.array([r[3] for r in replies])
    warmups = len(health["warmup_buckets_s"]) * len(health["row_sizes"])
    audio_s = sum(w.shape[-1] for w in waves) / SR
    print(f"  {what} on {health['device_name']} ({health['device']}), N={SERVE_N} "
          f"({nfe} NFE), row sizes {health['row_sizes']}, {warmups} warm-up calls; "
          f"built in {build_s:.2f} s", flush=True)
    print(f"  {what}: {n} requests ({audio_s:.3f} s of audio) from {SERVE_CLIENTS} clients in "
          f"{wall:.3f} s: {audio_s / wall:.4f} audio s served per wall s", flush=True)
    print(f"  {what}: latency p50 {np.percentile(latency, 50):.3f} s, p95 "
          f"{np.percentile(latency, 95):.3f} s, max {latency.max():.3f} s (over {n} requests "
          f"the p95 is interpolated between the two slowest: a smoke reading, not a tail)",
          flush=True)
    print(f"  {what}: {stats['batches']} batches, batch fill {stats['batch_fill']} "
          f"({stats['batched_requests']} requests in {stats['row_slots']} rows), device_s "
          f"{stats['device_s']:.3f}, /stats rtf {stats['rtf']}", flush=True)
    check(health["dtype"] == args.dtype, f"{what}: /healthz reports dtype {health['dtype']}")
    return dict(stats=stats, health=health, warmups=warmups, k1=kup.upfirdn2d_cuda.launches,
                k3=kq.quantize_int8_cuda.launches, k1_shapes=k1_shapes, k3_shapes=k3_shapes,
                build_text=build_text, audio_per_s=audio_s / wall,
                p50=float(np.percentile(latency, 50)), max=float(latency.max()))


def phase_server(workdir: str, calib_dir: str, gen: torch.Generator):
    """Phase 15. Returns ({path: upfirdn2d launches}, K3 launches, K1 error, K3 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    f32 = run_server("f32 server", serve_args(ckpt, "--dtype", "float32"), waves)
    want = K1_PER_FORWARD * SERVE_NFE * (f32["warmups"] + f32["stats"]["batches"])
    print(f"  f32 server: upfirdn2d launches {f32['k1']} (expected {K1_PER_FORWARD} x "
          f"{SERVE_NFE} x "
          f"({f32['warmups']} warm-up + {f32['stats']['batches']} batches) = {want})", flush=True)
    check(f32["k1"] == want and f32["k3"] == 0, f"f32 server launched {f32['k1']}, {f32['k3']}")

    # int8 at a checkpoint path of its own, so that it calibrates
    ckpt8 = os.path.join(workdir, "storm_serve.pt")
    os.link(ckpt, ckpt8)
    q = run_server("int8 server", serve_args(ckpt8, "--dtype", "float32", "--quant", "int8",
                                             "--calib_dir", calib_dir), waves[:INT8_REQUESTS])
    check(os.path.exists(scale_cache_path(ckpt8)), "the int8 server did not write its scales")
    served = q["warmups"] + q["stats"]["batches"]
    want1 = K1_PER_FORWARD * (calib_forwards(min(SERVE_N, 10)) + SERVE_NFE * served)
    want3 = N_QUANT * SERVE_NFE * served
    print(f"  int8 server: quantizer launches {q['k3']} (expected {N_QUANT} x {SERVE_NFE} x "
          f"({q['warmups']} warm-up + {q['stats']['batches']} batches) = {want3}; calibration "
          f"launches none), upfirdn2d {q['k1']} (expected {want1}, calibration included)",
          flush=True)
    check(q["k3"] == want3 and q["k1"] == want1, f"int8 server launched {q['k3']}, {q['k1']}")
    k1_err = check_k1_at("the servers", f32["k1_shapes"] | q["k1_shapes"], gen)
    k3_err = check_k3_at("the int8 server", q["k3_shapes"], gen)
    return {"server": f32["k1"], "server_int8": q["k1"]}, q["k3"], k1_err, k3_err


def phase_streaming(workdir: str, gen: torch.Generator):
    """Phase 16: the streaming CLI on one long file, f32 then int8, with K1
    held to plain at every shape both runs gave it and K3 at every input
    shape of the int8 run. Returns ({path: upfirdn2d launches}, K3 launches,
    K1 error, K3 error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "stream_noisy")
    out = os.path.join(workdir, "stream_enhanced")
    lengths = write_named_wavs(noisy, (STREAM_S,), "long", seed=5)
    T = next(iter(lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    chunks = len(range(0, T - overlap, chunk - overlap))
    calls = -(-chunks // STREAM_ROWS)
    argv = ["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt, "--mode", "storm",
            "--N", str(SERVE_N), "--stream_chunk_s", str(STREAM_CHUNK_S), "--stream_overlap_s",
            str(STREAM_OVERLAP_S), "--timeit", "--device", "cuda"]
    k1, k3_launches, shapes, k3_shapes = {}, 0, set(), set()
    for run, extra in (("streaming", []), ("streaming_int8", ["--quant", "int8"])):
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        t0 = time.perf_counter()
        with shapes_recorded() as (k1_shapes, q_shapes):
            text = run_enhancement(argv + extra)
        wall = time.perf_counter() - t0
        check_outputs(out, lengths)
        shapes |= k1_shapes
        k3_shapes |= q_shapes
        k1[run] = kup.upfirdn2d_cuda.launches
        k3 = kq.quantize_int8_cuda.launches
        calib = calib_forwards(min(SERVE_N, 10)) if extra else 0
        want1 = K1_PER_FORWARD * (calib + SERVE_NFE * calls)
        want3 = N_QUANT * SERVE_NFE * calls if extra else 0
        rtf = rtf_of(text)
        print(f"  {run}: {T / SR:.1f} s file in {chunks} chunks of {chunk} samples "
              f"({bucket_frames(chunk)} frames), {calls} call(s) of {STREAM_ROWS} rows; "
              f"{wall:.2f} s wall, RTF {list(rtf.values())}; upfirdn2d launches {k1[run]} "
              f"(expected {want1}{' with calibration' if calib else ''}), quantizer {k3} "
              f"(expected {want3})", flush=True)
        check(k1[run] == want1 and k3 == want3, f"{run}: launches {k1[run]}, {k3}")
        if extra:
            k3_launches = k3
            meta = quant_mod.load_scales_with_meta(scale_cache_path(ckpt))[1]
            check(meta["stream_chunk_s"] == STREAM_CHUNK_S and meta["calib_len"] == chunk,
                  f"int8 scale cache meta {meta}")
            print(f"  int8 scale cache: stream_chunk_s {meta['stream_chunk_s']}, calib_len "
                  f"{meta['calib_len']}", flush=True)
    check(bool(k3_shapes), "the int8 streaming run gave the quantizer no input")
    return (k1, k3_launches, check_k1_at("streaming", shapes, gen),
            check_k3_at("the int8 streaming run", k3_shapes, gen))


def phase_profile_batch():
    """Phase 17: trace one B=4 enhancement at the 4 s bucket (CLI defaults)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    ys = np.stack([synth_wav(max(SECONDS), i, rng) for i in range(CLI_BATCH)])
    BucketedEnhancer(model, N=2, corrector="ald")(ys)  # warm-up at the same shapes
    enh = BucketedEnhancer(model, N=DEFAULT_N, corrector="ald")
    profile_run(f"enhance B={CLI_BATCH} x {max(SECONDS)} s ({FRAMES} frames)", lambda: enh(ys))


# --- bfloat16 serving (phases 18-23)

BF16 = torch.bfloat16
# GroupNorm inputs of a full-width net: 128 channels at the top level of a
# 4 s request (B=1) and 256 channels one level down at B=4
GN_SHAPES = [(1, 128, FREQS, FRAMES), (4, 256, FREQS // 2, FRAMES // 2)]
BF16_GROUPS = {
    **K1_GROUPS,
    "convolutions (cuDNN)": (("fprop", "dgrad", "wgrad", "implicit_convolve", "conv2d",
                              "convolve"), None),
    "NCHW/NHWC layout transforms": (("ToNhwc", "ToNchw", "nchwToNhwc", "nhwcToNchw"), None),
    "matrix products (cuBLAS)": (("nvjet", "xmma_gemm", "gemv"), None),
    "GroupNorm statistics (reductions)": (("reduce_kernel",), None),
    "elementwise": (("elementwise",), None),
}


def phase_bf16_kernels(gen: torch.Generator):
    """Phase 18. K1 in bfloat16 against plain at the main path's shapes (B=1,
    576 frames), timed; the adjoint's bfloat16 instance at every train-step
    backward shape (B=8, 256 x 256); GroupNorm on bfloat16 with float32 scale
    and bias against float32 GroupNorm rounded once; one full-width NCSN++
    forward in bfloat16 through the kernel and the plain version, and its
    time against float32's. Returns (per-shape times, the kernel's max error)."""
    per_shape, launch, max_err = {}, {}, 0.0
    for cfg, C, H, W in forward_shapes(FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        x = torch.randn(1, C, H, W, device="cuda", generator=gen).to(BF16)
        flips = [n[1] for n in BF16_FLIPS["upfirdn2d"].values()]
        max_err = max(max_err, check_forward(cfg, x))
        flips = "/".join(str(n[1] - f) for n, f in zip(BF16_FLIPS["upfirdn2d"].values(), flips))
        lib = library_call(cfg, C, dtype=BF16)
        want = kup.upfirdn2d_plain(x, c["kernel"], **args)
        lib_err = ulps_of_scale(lib(x), want)
        check(lib_err <= 2.0, f"library yardstick bf16 {cfg} C={C}: {lib_err:.2f} ulps off")
        Ho, Wo = want.shape[-2:]
        bytes_ms, ops_ms = bound_ms(C * H * W, C * Ho * Wo, 16 // (c["up"] ** 2), elem_bytes=2)
        per_shape[(cfg, C, H, W)] = dict(
            ms=time_ms(lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args)),
            plain_ms=time_ms(lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), reps=5),
            library_ms=time_ms(lambda: lib(x)), bytes_ms=bytes_ms, ops_ms=ops_ms,
            lib_err=lib_err, out=f"{Ho}x{Wo}", flips=flips)
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_cuda, x, c["kernel"], **args)
    print_per_shape("upfirdn2d bf16", per_shape, launch, "upfirdn2d_", k1_calls(6),
                    "score forward")
    print("  (bf16 lib_err in ulps of the output's scale; flips: elements that differ from "
          "plain, NCSN++'s FIR / the asymmetric one)", flush=True)

    bwd_calls = set(k1_bwd_calls())
    bwd_err = 0.0
    for cfg, C, H, W in forward_shapes(TRAIN_FRAMES):
        if (cfg, C, H, W) not in bwd_calls:
            continue
        c = CONFIGS[cfg]
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(TRAIN_B, C, Ho, Wo, device="cuda", generator=gen).to(BF16)
        for fir, kern in (("ncsnpp", c["kernel"]), ("asym", ASYM)):
            bwd = (g, kern, c["up"], c["down"], c["pad"], (H, W))
            terms = kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kern), *bwd[2:])
            bwd_err = max(bwd_err, compare(f"upfirdn2d_bwd bf16 {cfg} B={TRAIN_B} C={C} {H}x{W}",
                                           kup.upfirdn2d_bwd_cuda(*bwd),
                                           kup.upfirdn2d_bwd_plain(*bwd), "upfirdn2d_bwd", terms,
                                           fir))
    flips = BF16_FLIPS["upfirdn2d_bwd"]
    print(f"  upfirdn2d_bwd bf16 at every train-step backward shape (B={TRAIN_B}): within its "
          f"allowance of plain; elements that differ (by 1 ulp): {flips['ncsnpp'][1]} of "
          f"{flips['ncsnpp'][0]} with NCSN++'s FIR, {flips['asym'][1]} of {flips['asym'][0]} "
          f"with the asymmetric one; max abs err {bwd_err:.2e}", flush=True)
    torch.cuda.empty_cache()

    for shape in GN_SHAPES:
        C = shape[1]
        gn = group_norm(C).cuda().eval()
        with torch.no_grad():
            gn.weight.copy_(1.0 + 0.1 * torch.randn(C, device="cuda", generator=gen))
            gn.bias.copy_(0.1 * torch.randn(C, device="cuda", generator=gen))
        x = (torch.randn(shape, device="cuda", generator=gen) * 0.7 + 0.5).to(BF16)
        with torch.inference_mode():
            got = gn(x)
            want = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(BF16)
            worst = ulps_of_scale(got, want)
            differ = (got != want).float().mean().item()
            ms = time_ms(lambda: gn(x))
            f32 = x.float()
            ms_f32 = time_ms(lambda: F.group_norm(f32, gn.num_groups, gn.weight, gn.bias, gn.eps))
        print(f"  GroupNorm bf16 {shape} (float32 statistics, scale and bias): {worst:.2f} ulps "
              f"of the output's scale from float32 GroupNorm rounded once ({100 * differ:.4f}% "
              f"of elements differ); "
              f"{ms:.4f} ms against {ms_f32:.4f} ms for float32 GroupNorm of the float32 "
              f"tensor", flush=True)
        check(worst <= 1.0 and differ < 1e-3,
              f"GroupNorm bf16 {shape}: {worst:.2f} ulps, {differ:.2e} of elements from float32 "
              f"rounded once")
    torch.cuda.empty_cache()

    nets = {}
    for dtype in (torch.float32, BF16):
        net = NCSNpp(input_channels=6, init_scale=1.0, dtype=dtype)
        reset_parameters(net, torch.Generator().manual_seed(0))
        nets[dtype] = net.cuda().eval()
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode(), cast_params(nets[BF16], BF16):
        kup.upfirdn2d_cuda.launches = 0
        out_k = nets[BF16](x, t)
        torch.cuda.synchronize()
        launches = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            out_p = nets[BF16](x, t)
        out_32 = nets[torch.float32](x, t)
        ms = {dtype: time_ms(lambda: nets[dtype](x, t), reps=5, repeats=3) for dtype in nets}
    check(launches == 18, f"a bf16 NCSN++ forward launched upfirdn2d {launches} times")
    check(out_k.dtype == torch.float32 and bool(torch.isfinite(out_k).all()),
          "bf16 NCSN++ output is not finite float32")
    scale = out_32.abs().max().item()
    err = (out_k - out_p).abs().max().item()
    rel = (out_k - out_32).abs().max().item() / scale
    print(f"  NCSN++ forward in bf16 (full width, B=1, {FREQS} x {FRAMES}): kernel vs plain "
          f"path max abs err {err:.3e}; max|bf16 - f32| / max|f32| = {rel:.4e}; "
          f"{ms[BF16]:.2f} ms per forward against {ms[torch.float32]:.2f} ms in float32 "
          f"({ms[torch.float32] / ms[BF16]:.2f}x)", flush=True)
    check(err <= 1e-2 * scale, f"bf16 NCSN++ kernel path disagrees with plain ({err:.3e})")
    del nets
    torch.cuda.empty_cache()
    return per_shape, max(max_err, bwd_err)


def relative_to(outputs, reference):
    """{file: max|out - reference| / max|reference|} over the files of both."""
    return {name: float(np.abs(outputs[name] - reference[name]).max()
                        / np.abs(reference[name]).max()) for name in reference}


def phase_bf16_cli(workdir: str, f32_outputs, f32_rtf, lengths, batch_dir, batch_outputs,
                   gen: torch.Generator):
    """Phase 19. `python -m storm_tpu_torch.enhancement --dtype bfloat16` at the
    CLI defaults: the three files of phase 5, then `--batch 4` on phase 14's
    files, then `--quant int8`, which calibrates in bfloat16 (phase 16's
    streaming run left scales of another configuration in the cache; a
    cache of the same configuration would be reused whatever its dtype, as
    the reference's meta has none); exact launch counts, RTF, max|bf16 -
    f32| / max|f32| against the float32 runs on the same files and seed, K1
    at every shape. Returns ({path: K1 launches}, K3 launches, the K3 input
    shapes, K1's max error, {"bfloat16" or "int8_bfloat16": ({file: RTF},
    {file: output})} of the three files)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "noisy")
    base = ["--ckpt", ckpt, "--mode", "storm", "--timeit", "--device", "cuda", "--dtype",
            "bfloat16"]
    k1, shapes, k3_shapes, exact = {}, set(), set(), {}
    n_flag = ["--N", str(N_STEPS)]
    outputs = {}
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir",
                                os.path.join(workdir, "enhanced_bf16"), *base, *n_flag],
                               outputs)
    check_outputs(os.path.join(workdir, "enhanced_bf16"), lengths)
    shapes |= k1_shapes
    k1["enhancement_bf16"] = kup.upfirdn2d_cuda.launches
    want = 18 * NFE * len(SECONDS)
    rtf, rel = rtf_of(text), relative_to(outputs, f32_outputs)
    exact["bfloat16"] = (rtf, outputs)
    for name in lengths:
        print(f"  {name}: RTF bf16 {rtf[name]:.4f} against f32 {f32_rtf[name]:.4f} (phase 5); "
              f"max|bf16 - f32| / max|f32| = {rel[name]:.4e}", flush=True)
    print(f"  bf16 CLI: upfirdn2d launches {k1['enhancement_bf16']} (expected {want})",
          flush=True)
    check(k1["enhancement_bf16"] == want and kq.quantize_int8_cuda.launches == 0,
          f"bf16 CLI launched {k1['enhancement_bf16']}, {kq.quantize_int8_cuda.launches}")

    out, outputs = os.path.join(workdir, "batch_enhanced_bf16"), {}
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", batch_dir, "--enhanced_dir", out, "--batch",
                                str(CLI_BATCH), *base, "--N", str(DEPTH_N)], outputs)
    wall = time.perf_counter() - t0
    batches = [float(r) for r in re.findall(r"batch of \d+: nfe=\d+ rtf=([0-9.]+)", text)]
    shapes |= k1_shapes
    k1["batched_cli_bf16"] = kup.upfirdn2d_cuda.launches
    want = K1_PER_FORWARD * DEPTH_NFE * len(batches)
    rel = relative_to(outputs, batch_outputs)
    audio_s = sum(len(v) for v in batch_outputs.values()) / SR
    print(f"  bf16 --batch {CLI_BATCH}: {len(batches)} calls, RTF per batch {batches}; "
          f"{audio_s / wall:.4f} audio s per wall s; max|bf16 - f32| / max|f32| up to "
          f"{max(rel.values()):.4e}; upfirdn2d launches {k1['batched_cli_bf16']} "
          f"(expected {want})", flush=True)
    check(len(batches) == 2 and k1["batched_cli_bf16"] == want,
          f"bf16 batched CLI: {batches}, {k1['batched_cli_bf16']} launches")

    out, outputs = os.path.join(workdir, "enhanced_int8_bf16"), {}
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, q_shapes):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--quant", "int8",
                                "--quant_min_channels", str(QUANT_MIN_CHANNELS), *base,
                                *n_flag], outputs)
    check_outputs(out, lengths)
    calibrated = "int8 calibration done" in text
    check(calibrated or f"int8 scales loaded from {scale_cache_path(ckpt)}" in text,
          "the int8 bf16 run neither calibrated nor loaded scales")
    shapes |= k1_shapes
    k3_shapes |= q_shapes
    k1["enhancement_int8_bf16"] = kup.upfirdn2d_cuda.launches
    k3 = kq.quantize_int8_cuda.launches
    rtf, rel = rtf_of(text), relative_to(outputs, f32_outputs)
    exact["int8_bfloat16"] = (rtf, outputs)
    for name in lengths:
        print(f"  {name}: RTF int8 bf16 {rtf[name]:.4f}; max|int8 bf16 - f32| / max|f32| = "
              f"{rel[name]:.4e}", flush=True)
    want = 18 * (NFE * len(SECONDS) + (CALIB_FORWARDS if calibrated else 0))
    print(f"  int8 bf16 CLI ({'calibrated in bf16' if calibrated else 'scales loaded'}): "
          f"quantizer launches {k3} (expected {K3_PER_FILE * len(SECONDS)}), upfirdn2d "
          f"{k1['enhancement_int8_bf16']} (expected {want})", flush=True)
    check(k3 == K3_PER_FILE * len(SECONDS) and k1["enhancement_int8_bf16"] == want,
          f"int8 bf16 CLI launched {k3}, {k1['enhancement_int8_bf16']}")
    check({s[-1] for s in shapes} == {BF16}, f"a bf16 run gave upfirdn2d {shapes}")
    check({(d, p) for _, d, p in k3_shapes} == {(BF16, BF16)},
          f"the int8 bf16 run's quantizer inputs {k3_shapes}")
    return k1, k3, k3_shapes, check_k1_at("the bf16 CLI runs", shapes, gen), exact


def phase_bf16_quantizer(workdir: str):
    """Phase 20. K3's bfloat16-product mode at every quantized-conv input of
    one int8 bf16 forward of each net at the 4 s request's width (110 calls),
    bfloat16-product ties and saturating values written in: codes identical
    to plain; per-shape times for the score net. Returns (per-shape times,
    the score forward's shapes, the largest |kernel code - plain code|)."""
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    quant = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    name = f"utt{len(SECONDS) - 1}_{SECONDS[-1]:.1f}s.wav"
    y = bucketed(load_wav(os.path.join(workdir, "noisy", name))[0])
    calls = []

    def capture(net):
        def hook(mod, inp, out):
            if mod.a_scale is not None:
                calls.append((net, inp[0].clone(), qconv.activation_inverse(mod.a_scale)))
        return hook

    hooks = [m.register_forward_hook(capture(net))
             for net in ("denoiser", "score")
             for m in qconv.quantizable_convs(getattr(model, f"{net}_net")).values()]
    try:
        with torch.inference_mode():
            model.enhance(y, N=1, corrector="none", quant=quant)
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == 2 * N_QUANT and all(x.dtype == BF16 for _, x, _ in calls),
          f"{len(calls)} bf16 quantized conv calls, expected {2 * N_QUANT}")
    per_shape, launch, score_shapes, ties, max_err = {}, {}, [], 0, 0
    with torch.inference_mode():
        for net, x, inv in calls:
            shape = tuple(x.shape)
            ties += with_ties(x, inv, BF16)
            max_err = max(max_err, check_codes(f"{net} {shape} bf16", x, inv, BF16))
            if net != "score":
                continue
            score_shapes.append(shape)
            if shape not in per_shape:
                bytes_ms, ops_ms = k3_bound_ms(x)
                per_shape[shape] = dict(
                    ms=time_ms(lambda: kq.quantize_int8_cuda(x, inv, BF16)),
                    plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, inv, BF16), reps=5),
                    bytes_ms=bytes_ms, ops_ms=ops_ms, calls=0)
                launch[shape] = functools.partial(kq.quantize_int8_cuda, x, inv, BF16)
            per_shape[shape]["calls"] += 1
        for shape, dev in zip(launch, device_ms(list(launch.values()), "quantize_int8_kernel")):
            per_shape[shape]["device_ms"] = dev
    del calls, launch, model
    print(f"  {2 * N_QUANT} quantized conv inputs (bf16, product in bf16), {ties} bf16-product "
          f"ties written in: codes identical to plain", flush=True)
    for shape, r in per_shape.items():
        print(f"  quantize_int8 bf16-product {shape} x{r['calls']} per score forward: "
              f"ms={r['ms']:.5f} device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} (bytes) device/bound="
              f"{r['device_ms'] / r['bytes_ms']:.2f}", flush=True)
    torch.cuda.empty_cache()
    return per_shape, score_shapes, max_err


def phase_bf16_server(workdir: str, gen: torch.Generator):
    """Phase 21. The server at its default dtype (bfloat16) on phase 15's
    burst, then int8 + bf16 on phase 15's int8 checkpoint (its scales
    loaded). Returns ({path: K1 launches}, K3 launches, K1 error, K3 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    args = serve_args(ckpt)
    check(args.dtype == "bfloat16", f"the server's default dtype is {args.dtype}")
    bf = run_server("bf16 server", args, waves)
    want = K1_PER_FORWARD * SERVE_NFE * (bf["warmups"] + bf["stats"]["batches"])
    print(f"  bf16 server: upfirdn2d launches {bf['k1']} (expected {want})", flush=True)
    check(bf["k1"] == want and bf["k3"] == 0, f"bf16 server launched {bf['k1']}, {bf['k3']}")
    ckpt8 = os.path.join(workdir, "storm_serve.pt")
    q = run_server("int8 bf16 server", serve_args(ckpt8, "--quant", "int8"),
                   waves[:INT8_REQUESTS])
    check("int8 scales loaded" in q["build_text"], "the int8 bf16 server did not load its scales")
    served = q["warmups"] + q["stats"]["batches"]
    want1, want3 = K1_PER_FORWARD * SERVE_NFE * served, N_QUANT * SERVE_NFE * served
    print(f"  int8 bf16 server: quantizer launches {q['k3']} (expected {want3}), upfirdn2d "
          f"{q['k1']} (expected {want1}); audio s per wall s {q['audio_per_s']:.4f} against "
          f"bf16's {bf['audio_per_s']:.4f}", flush=True)
    check(q["k3"] == want3 and q["k1"] == want1, f"int8 bf16 server launched {q['k3']}, {q['k1']}")
    check({s[-1] for s in bf["k1_shapes"] | q["k1_shapes"]} == {BF16}, "a bf16 server ran f32")
    k1_err = check_k1_at("the bf16 servers", bf["k1_shapes"] | q["k1_shapes"], gen)
    k3_err = check_k3_at("the int8 bf16 server", q["k3_shapes"], gen)
    return {"server_bf16": bf["k1"], "server_int8_bf16": q["k1"]}, q["k3"], k1_err, k3_err


def phase_bf16_streaming(workdir: str, gen: torch.Generator):
    """Phase 22. The streaming CLI in bfloat16 on phase 16's 12 s file.
    Returns (K1 launches, K1 error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "stream_noisy"), os.path.join(workdir, "stream_bf16")
    lengths = {f: load_wav(os.path.join(noisy, f))[0].shape[-1] for f in os.listdir(noisy)}
    T = next(iter(lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    calls = -(-len(range(0, T - overlap, chunk - overlap)) // STREAM_ROWS)
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--N", str(SERVE_N), "--stream_chunk_s",
                                str(STREAM_CHUNK_S), "--stream_overlap_s", str(STREAM_OVERLAP_S),
                                "--timeit", "--device", "cuda", "--dtype", "bfloat16"])
    wall = time.perf_counter() - t0
    check_outputs(out, lengths)
    launches = kup.upfirdn2d_cuda.launches
    want = K1_PER_FORWARD * SERVE_NFE * calls
    print(f"  streaming bf16: {T / SR:.1f} s file, {calls} call(s) of {STREAM_ROWS} rows; "
          f"{wall:.2f} s wall, RTF {list(rtf_of(text).values())}; upfirdn2d launches "
          f"{launches} (expected {want})", flush=True)
    check(launches == want and {s[-1] for s in k1_shapes} == {BF16},
          f"streaming bf16 launched {launches}")
    return launches, check_k1_at("bf16 streaming", k1_shapes, gen)


def phase_profile_bf16():
    """Phase 23: trace one bfloat16 enhancement of the 4 s file (CLI defaults)."""
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald")  # warm-up at the same shapes
    profile_run(f"bf16 enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=DEFAULT_N, corrector="ald"), BF16_GROUPS)


# --- bfloat16 training (phases 24-28)


def global_norm(grads) -> float:
    return torch.sqrt(sum((v.double() ** 2).sum() for v in grads.values())).item()


def grad_distance(a, b) -> float:
    return torch.sqrt(sum(((a[n].double() - b[n].double()) ** 2).sum() for n in b)).item()


def phase_bf16_backward(gen: torch.Generator):
    """Phase 24. K1 in bfloat16 at every train-step shape (B=8, 256 x 256):
    the forward at every forward shape and, where the step takes one, the
    gradient through `UpFirDn2d` (the backward kernel) against autograd of
    the plain version, both FIRs, each element within 1 ulp plus the float32
    sum's rounding, the elements that differ counted in BF16_FLIPS; the
    backward kernel timed (event and L2-cold device time) beside the plain
    backward, the bf16 adjoint library call and the 2 B-per-element bound.
    Then one full-width bf16 step's gradients (B=2) through the kernels
    against the plain path and against float32 (cuDNN deterministic), and
    one B=8 step's time and peak memory with the port's GroupNorm and with
    its arithmetic left to autograd, beside the bytes of the float32 copies
    that autograd keeps. Returns (per-shape times, max error)."""
    bwd_calls = set(k1_bwd_calls())
    per_shape, launch, max_err = {}, {}, 0.0
    for cfg, C, H, W in forward_shapes(TRAIN_FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        needs_grad = (cfg, C, H, W) in bwd_calls
        what = f"bf16 {cfg} B={TRAIN_B} C={C} {H}x{W}"
        x = torch.randn(TRAIN_B, C, H, W, device="cuda", generator=gen).to(BF16)
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(TRAIN_B, C, Ho, Wo, device="cuda", generator=gen).to(BF16)
        for fir, kern in (("asym", ASYM), ("ncsnpp", c["kernel"])):  # NCSN++'s last
            xk = x.clone().requires_grad_(needs_grad)
            xp = x.clone().requires_grad_(needs_grad)
            out_k, out_p = kup.upfirdn2d(xk, kern, **args), kup.upfirdn2d_plain(xp, kern, **args)
            terms = kup.upfirdn2d_plain(x.abs(), np.abs(kern), **args)
            max_err = max(max_err, compare(f"upfirdn2d {what}", out_k.detach(), out_p.detach(),
                                           terms=terms, fir=fir))
            if needs_grad:
                (got,) = torch.autograd.grad(out_k, xk, g)
                (want,) = torch.autograd.grad(out_p, xp, g)
                check(got.dtype == BF16, f"upfirdn2d_bwd {what}: gradient in {got.dtype}")
                terms = kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kern), c["up"], c["down"],
                                                c["pad"], (H, W))
                max_err = max(max_err, compare(f"upfirdn2d_bwd {what}", got, want,
                                               "upfirdn2d_bwd", terms, fir))
        if not needs_grad:
            continue
        lib = library_call(cfg, C, backward=True, dtype=BF16)
        lib_err = ulps_of_scale(lib(g), want)
        check(lib_err <= 2.0, f"library yardstick bf16 bwd {cfg} C={C}: {lib_err:.2f} ulps off")
        bwd = (g, c["kernel"], c["up"], c["down"], c["pad"], (H, W))
        bytes_ms, ops_ms = bound_ms(g.numel(), x.numel(), 16 // (c["down"] ** 2), elem_bytes=2)
        per_shape[(cfg, C, H, W)] = dict(
            ms=time_ms(lambda: kup.upfirdn2d_bwd_cuda(*bwd)),
            plain_ms=time_ms(lambda: kup.upfirdn2d_bwd_plain(*bwd), reps=5),
            library_ms=time_ms(lambda: lib(g)), bytes_ms=bytes_ms, ops_ms=ops_ms,
            lib_err=lib_err, out=f"(g {Ho}x{Wo} -> grad x {H}x{W})")
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_bwd_cuda, *bwd)
    print_per_shape(f"upfirdn2d_bwd bf16 (B={TRAIN_B}) of", per_shape, launch, "upfirdn2d_",
                    k1_bwd_calls(), "joint-training step")
    flips = BF16_FLIPS["upfirdn2d_bwd"]
    print(f"  bf16 forward and gradient at every train-step shape within their allowance of "
          f"plain, max abs err {max_err:.2e}; adjoint elements that differ (phases 18 and 24): "
          f"{flips['ncsnpp'][1]} of {flips['ncsnpp'][0]} with NCSN++'s FIR, {flips['asym'][1]} "
          f"of {flips['asym'][0]} with the asymmetric one (lib_err in ulps)", flush=True)
    torch.cuda.empty_cache()

    B = 2
    x = 0.3 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    y = x + 0.2 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    t = torch.tensor([0.3, 0.8], device="cuda")
    z = torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen) / 2 ** 0.5
    models = {dtype: build_model(dict(STORM_CONFIG, dtype=dtype), device="cuda", seed=0).train()
              for dtype in ("float32", "bfloat16")}
    dtypes, launch_fn = [], kup._launch

    def watched(xx, *a):
        dtypes.append(xx.dtype)
        return launch_fn(xx, *a)

    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        with mock.patch.object(kup, "_launch", watched):
            g_k = grads_of(models["bfloat16"], (x, y), t, z)
            torch.cuda.synchronize()
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            g_p = grads_of(models["bfloat16"], (x, y), t, z)
            g_32 = grads_of(models["float32"], (x, y), t, z)
            torch.cuda.synchronize()
        check(counts == (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches),
              "the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    check(counts == (STEP_FWD, STEP_BWD) and set(dtypes) == {BF16},
          f"one bf16 step's gradients launched {counts} on {set(dtypes)}")
    check(all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32 for v in g_k.values()),
          "bf16 gradients not finite float32")
    effect = grad_distance(g_p, g_32)
    d_plain, d_f32 = grad_distance(g_k, g_p), grad_distance(g_k, g_32)
    print(f"  B={B} full-width bf16 gradients: launches {counts}, all bf16; |kernel - plain| "
          f"{d_plain:.4e} = {d_plain / effect:.4f} of |bf16 - f32| {effect:.4e} (both plain; "
          f"global norm {global_norm(g_32):.4e}); |kernel - f32| = {d_f32 / effect:.4f} of it",
          flush=True)
    check(d_plain <= 0.1 * effect, "bf16 gradients through the kernels disagree with the plain path")
    check(d_f32 >= 0.5 * effect, "the bf16 step's gradients are as close to f32 as f32 itself")
    del g_k, g_p, g_32, models["float32"]
    torch.cuda.empty_cache()

    # one B=8 step, timed and its peak memory read, with the port's GroupNorm
    # (LowPrecisionGroupNorm: it keeps x, in bf16) and with the same
    # arithmetic left to autograd, which keeps a float32 copy of each bf16
    # input for var_mean's backward (4 B per element, counted here)
    model = models["bfloat16"]
    xb = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    batch = (xb, xb + 0.2 * torch.randn(xb.shape, device="cuda", generator=gen))
    tb, zb = model.draw_tz(xb, gen)
    copies = [0]

    def count(module, inputs):
        if inputs[0].dtype == BF16 and torch.is_grad_enabled():
            copies[0] += 4 * inputs[0].numel()

    def autograd_group_norm(self, x):
        if x.dtype == self.weight.dtype:
            return torch.nn.GroupNorm.forward(self, x)
        B, C = x.shape[:2]
        G = self.num_groups
        var, mean = torch.var_mean(x.reshape(B, G, -1).float(), dim=-1, correction=0)
        mul = (torch.rsqrt(var + self.eps)[:, :, None] * self.weight.view(G, -1)).reshape(B, C)
        add = self.bias - mean.repeat_interleave(C // G, dim=1) * mul
        shape = (B, C) + (1,) * (x.dim() - 2)
        return torch.addcmul(add.view(shape), x, mul.view(shape)).to(x.dtype)

    hooks = [m.register_forward_pre_hook(count) for m in model.modules()
             if isinstance(m, GroupNorm)]
    step = {}
    for label, forward in (("LowPrecisionGroupNorm", GroupNorm.forward),
                           ("autograd", autograd_group_norm)):
        with mock.patch.object(GroupNorm, "forward", forward):
            model.compute_gradients(batch, tb, zb)  # warm-up: the allocator's blocks
            torch.cuda.synchronize()
            copies[0] = 0
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            events = []
            for _ in range(3):
                events.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                events[-1][0].record()
                model.compute_gradients(batch, tb, zb)
                events[-1][1].record()
            torch.cuda.synchronize()
            step[label] = dict(peak=torch.cuda.max_memory_allocated(), base=base,
                               ms=statistics.median(a.elapsed_time(b) for a, b in events),
                               grads={n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.requires_grad})
    for h in hooks:
        h.remove()
    kept = copies[0] / 3
    mine, auto = step["LowPrecisionGroupNorm"], step["autograd"]
    d_gn = grad_distance(mine["grads"], auto["grads"])
    print(f"  one bf16 step at B={TRAIN_B} (kernel path), GroupNorm as the port runs it against "
          f"its arithmetic left to autograd: {mine['ms']:.2f} against {auto['ms']:.2f} ms "
          f"(compute_gradients, median of 3); peak {mine['peak'] / 2**30:.2f} against "
          f"{auto['peak'] / 2**30:.2f} GiB ({mine['base'] / 2**30:.2f} GiB held before); the "
          f"float32 copies autograd keeps for GroupNorm's backward {kept / 2**30:.2f} GiB; "
          f"gradients {d_gn / global_norm(auto['grads']):.3e} of their norm apart (the float32 "
          f"sums' order, carried by bf16's rounding)", flush=True)
    check(mine["peak"] < auto["peak"], "LowPrecisionGroupNorm does not lower the peak")
    del mine, auto, step
    del model, models
    torch.cuda.empty_cache()
    return per_shape, max_err


def phase_fused_act_bf16(gen: torch.Generator):
    """Phase 27. K2 in bfloat16 through its op API at K2_SHAPES: the forward
    equal to the plain version, the input gradient within 1 ulp of each
    element of autograd of the plain version and the bias gradient within 1
    ulp of its scale; timed against its bound (4 B per element, x in and out;
    5 with the mask)."""
    inputs = [tuple((torch.randn(shape if i != 1 else shape[-1:], device="cuda", generator=gen)
                     * (3.0 if i == 0 else 1.0)).to(BF16) for i in range(3))
              for shape in K2_SHAPES]
    kfa.fused_leaky_relu_cuda.launches = 0
    results = []
    for x, b, g in inputs:
        xk, bk = x.clone().requires_grad_(), b.clone().requires_grad_()
        out = kfa.fused_leaky_relu(xk, bk)
        results.append((out.detach(), *torch.autograd.grad(out, (xk, bk), g)))
    torch.cuda.synchronize()
    launches = kfa.fused_leaky_relu_cuda.launches
    check(launches == len(K2_SHAPES), f"fused_leaky_relu bf16 launched {launches} times")
    max_err, grad_ulps = 0.0, [0.0, 0.0]
    for (x, b, g), (out, gx, gb) in zip(inputs, results):
        xp, bp = x.clone().requires_grad_(), b.clone().requires_grad_()
        want = kfa.fused_leaky_relu_plain(xp, bp)
        hx, hb = torch.autograd.grad(want, (xp, bp), g)
        what = f"fused_leaky_relu bf16 {tuple(x.shape)}"
        check(out.dtype == gx.dtype == gb.dtype == BF16, f"{what}: not bf16")
        fwd_err = (out.float() - want.float()).abs().max().item()
        check(torch.equal(out, want.detach()), f"{what} forward: max abs err {fwd_err:.3e} "
                                               f"(must be 0)")
        ulp = torch.exp2(torch.floor(torch.log2(hx.float().abs().clamp_min(2.0 ** -126))) - 7)
        gx_ulps = ((gx.float() - hx.float()).abs() / ulp).max().item()
        gb_ulps = ulps_of_scale(gb, hb)
        differ = (gx != hx).float().mean().item()
        check(gx_ulps <= 1.0 and gb_ulps <= 1.0,
              f"{what}: grad x {gx_ulps:.2f} ulps of an element, grad bias {gb_ulps:.2f} ulps of "
              f"its scale from autograd of plain")
        max_err = max(max_err, fwd_err)  # the kernel's own output: the backward is plain
        grad_ulps = [max(grad_ulps[0], gx_ulps), max(grad_ulps[1], gb_ulps)]
        print(f"  {what}: forward equal; grad x at most {gx_ulps:.2f} ulp of an element from "
              f"autograd of plain ({100 * differ:.3f}% of elements differ: the reference's order "
              f"of the two products), grad bias {gb_ulps:.3f} ulp of its scale", flush=True)
    x, b, _ = inputs[0]
    n = x.numel()
    bytes_ms = (4.0 * n + 2.0 * b.numel()) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4.0 * n / PEAK_F32_FLOP_PER_S * 1e3
    with torch.no_grad():
        r = dict(ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b)),
                 device_ms=device_ms([lambda: kfa.fused_leaky_relu_cuda(x, b)],
                                     "fused_leaky_relu_kernel")[0],
                 mask_ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b, with_mask=True)),
                 plain_ms=time_ms(lambda: kfa.fused_leaky_relu_plain(x, b), reps=5),
                 bytes_ms=bytes_ms, ops_ms=ops_ms, launches=launches, max_abs_err=max_err,
                 grad_x_ulps_of_element=grad_ulps[0], grad_bias_ulps_of_scale=grad_ulps[1])
    print(f"  fused_leaky_relu bf16 {tuple(x.shape)}: ms={r['ms']:.5f} "
          f"device_ms={r['device_ms']:.5f} (with the mask {r['mask_ms']:.5f}) "
          f"plain_ms={r['plain_ms']:.5f} bound_ms={max(bytes_ms, ops_ms):.5f} (bytes; 5 B per "
          f"element with the mask: {5.0 * n / PEAK_BYTES_PER_S * 1e3:.5f})", flush=True)
    return r


def phase_profile_train_bf16():
    """Phase 28: trace two full-width bf16 train steps (B=8, 256 x 256)."""
    phase_profile_train("bfloat16", BF16_GROUPS)


# --- deep-feature caching and the bench (phases 29-33)

DC_K, DC_DEPTH = 3, 1  # bench.py's production refresh interval, the default cache depth
BENCH_REPS = 1  # the bench's timed reps here (its default, 3, in a run of its own)
BENCH_N = 5  # the bench's serving line's N here (its default, 50, in a run of its own)


def pass_modules(net: NCSNpp, depth: int = DC_DEPTH):
    """{pass: the indices of net.all_modules it runs}, read from the module
    list: the full forward runs them all; the deep pass everything before up
    level depth - 1; the shallow pass the down trunk before level depth - 1's
    downsampling resblock (skipped, with the pyramid combine after it) and
    the up path from level depth - 1 on."""
    mods = net.all_modules
    up = net._up_start_idx[depth - 1]
    downs = [i for i, m in enumerate(mods) if isinstance(m, ResnetBlockBigGANpp) and m.down]
    return {"full": list(range(len(mods))), "deep": list(range(up)),
            "shallow": list(range(downs[depth - 1])) + list(range(up, len(mods)))}


def k1_of_module(net: NCSNpp, i: int) -> int:
    """upfirdn2d calls of module i of NCSN++'s list: 2 for a FIR-resampling
    BigGAN resblock (h and its skip), 1 for a FIR resampler with a conv (the
    DDPM resblock's levels, the residual pyramids: the stride-1 call), 1 for
    an input_skip pyramid's combine (the pyramid's downsampling before it),
    1 for an output_skip up level's pyramid GroupNorm below the top level
    (the pyramid's upsampling after it)."""
    m = net.all_modules[i]
    if isinstance(m, ResnetBlockBigGANpp):
        return 2 if (m.up or m.down) and m.fir else 0
    if isinstance(m, (Upsample, Downsample)):
        return int(m.fir)
    if isinstance(m, Combine):
        return int(net.pyramid_downsample.fir)
    if isinstance(m, GroupNorm) and net.progressive == "output_skip":
        # the up path's pyramid norms; the top level's comes first
        return int(net.pyramid_upsample.fir and i > net._up_start_idx[net.num_resolutions - 2])
    return 0


def k1_per_forward(net) -> int:
    """upfirdn2d calls of one forward of `net`, from its module list (none
    for a net without one, as ConvTasNet)."""
    mods = getattr(net, "all_modules", ())
    return sum(k1_of_module(net, i) for i in range(len(mods)))


def per_pass(net: NCSNpp, scales=None, depth: int = DC_DEPTH):
    """({pass: K1 calls}, {pass: K3 calls}) of one pass of `net`, K3 for the
    convs named in `scales` ({"all_modules.<i>.<conv>": a_scale})."""
    passes = pass_modules(net, depth)
    k1 = {p: sum(k1_of_module(net, i) for i in idx) for p, idx in passes.items()}
    k3 = {p: sum(int(name.split(".")[1]) in set(idx) for name in (scales or {}))
          for p, idx in passes.items()}
    return k1, k3


def deep_passes(n_steps: int, k: int = DC_K) -> int:
    """Deep passes of one sampler run: at the prior and at each refresh."""
    return 1 + sum(1 for i in range(n_steps) if i % k == 0 and i > 0)


@functools.lru_cache(maxsize=None)
def storm_structure():
    """The full-width (denoiser, score net), for their module lists only."""
    return NCSNpp(input_channels=2, discriminative=True), NCSNpp(input_channels=6)


def dc_call_launches(n_steps: int, evals_per_step: int, scales=None, k: int = DC_K):
    """(K1, K3) launches of one enhance call with deepcache k: the
    denoiser's full forward, a deep pass at the prior and at each refresh,
    a shallow pass per score evaluation. `scales`: {"denoiser", "score"}."""
    den, score = storm_structure()
    scales = scales or {}
    d1, d3 = per_pass(den, scales.get("denoiser"))
    s1, s3 = per_pass(score, scales.get("score"))
    deep, evals = deep_passes(n_steps, k), n_steps * evals_per_step
    return (d1["full"] + deep * s1["deep"] + evals * s1["shallow"],
            d3["full"] + deep * s3["deep"] + evals * s3["shallow"])


def phase_deepcache_forward(workdir: str, gen: torch.Generator):
    """Phase 29. One full-width score net at the 4 s bucket (B=1, 256 x 576):
    forward_shallow(deep_features(x)) against forward(x), in float32, in
    bf16, and with int8 scales attached in both (the scales of phase 19's
    cache), with each pass's K1 and K3 launches held to the counts read from
    the module list; the passes' times. Returns ({path: K1 launches},
    {path: K3 launches}) of the float32 and bf16 runs."""
    den, score = storm_structure()
    scales = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    k1_want, k3_want = per_pass(score, scales["score"])
    print(f"  from the module list, depth {DC_DEPTH}: upfirdn2d calls per pass {k1_want}; "
          f"quantizer calls per pass at --quant_min_channels {QUANT_MIN_CHANNELS} {k3_want}",
          flush=True)
    check(k1_want["full"] == K1_PER_FORWARD and k3_want["full"] == N_QUANT
          and per_pass(den)[0]["full"] == K1_PER_FORWARD,
          f"a full forward's counts {k1_want['full']}, {k3_want['full']} from the module list")
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    k1_paths, k3_paths = {}, {}
    for dtype in (torch.float32, BF16):
        net = NCSNpp(input_channels=6, init_scale=1.0, dtype=dtype)
        reset_parameters(net, torch.Generator().manual_seed(0))
        net = net.cuda().eval()
        name = "float32" if dtype == torch.float32 else "bf16"
        for quant in (False, True):
            what = f"{'int8 ' if quant else ''}{name}"
            ctx = qconv.scales_attached(net, scales["score"]) if quant else contextlib.nullcontext()
            launched, outs = {}, {}
            with torch.inference_mode(), cast_params(net, dtype), ctx:
                kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
                for kind in ("full", "deep", "shallow"):
                    before = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
                    if kind == "full":
                        outs[kind] = net(x, t)
                    elif kind == "deep":
                        outs[kind] = net.deep_features(x, t, cache_depth=DC_DEPTH)
                    else:
                        outs[kind] = net.forward_shallow(x, t, outs["deep"], cache_depth=DC_DEPTH)
                    torch.cuda.synchronize()
                    launched[kind] = (kup.upfirdn2d_cuda.launches - before[0],
                                      kq.quantize_int8_cuda.launches - before[1])
                path = f"forward_dc_{'int8_' if quant else ''}{name}"
                k1_paths[path] = kup.upfirdn2d_cuda.launches
                k3_paths[path] = kq.quantize_int8_cuda.launches
                cache = outs["deep"]
                ms = {"full": time_ms(lambda: net(x, t), reps=3, repeats=3),
                      "deep": time_ms(lambda: net.deep_features(x, t, cache_depth=DC_DEPTH),
                                      reps=3, repeats=3),
                      "shallow": time_ms(lambda: net.forward_shallow(
                          x, t, cache, cache_depth=DC_DEPTH), reps=3, repeats=3)}
            want = {k: (k1_want[k], k3_want[k] if quant else 0) for k in launched}
            check(launched == want, f"{what} passes launched {launched}, expected {want}")
            check(all(c.dtype == dtype for c in cache), f"{what}: the cache is "
                                                        f"{[c.dtype for c in cache]}")
            full, shallow = outs["full"], outs["shallow"]
            check(bool(torch.isfinite(shallow).all()), f"{what}: shallow output not finite")
            scale = full.abs().max().item()
            err = (shallow - full).abs().max().item()
            print(f"  {what}: forward_shallow(deep_features(x)) against forward(x): max abs err "
                  f"{err:.3e} (scale {scale:.3e}); launches per pass (K1, K3) {launched}; ms "
                  f"full {ms['full']:.2f}, deep {ms['deep']:.2f} ({ms['deep'] / ms['full']:.3f} "
                  f"of full), shallow {ms['shallow']:.2f} ({ms['shallow'] / ms['full']:.3f})",
                  flush=True)
            # the shallow pass reruns the forward's own operations on the same shapes
            check(err <= 1e-6 * scale, f"{what}: shallow of deep differs from the forward "
                                       f"by {err:.3e}")
        del net, outs, cache
        torch.cuda.empty_cache()
    return k1_paths, k3_paths


def phase_deepcache_cli(workdir: str, lengths, exact, gen: torch.Generator):
    """Phase 30. `python -m storm_tpu_torch.enhancement --deepcache 3` on phase
    5's three files at the CLI defaults (N=50 + ald) in float32, in bf16 and
    at `--quant int8 --dtype bfloat16` (phase 19's scales, loaded): exact K1
    and K3 launches per file from the module list, every K1 shape and K3
    input the runs gave held to plain, the RTF and max|x - exact| /
    max|exact| against the exact runs of the same files in this script
    (`exact`: {config: ({file: RTF}, {file: output})}). Returns ({path: K1
    launches}, {path: K3 launches}, K1's float32 and bf16 errors, K3 error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "noisy")
    scales = quant_mod.load_scales(scale_cache_path(ckpt))
    k1_paths, k3_paths, k1_shapes, k3_shapes = {}, {}, set(), set()
    for config, dtype, extra in (
            ("float32", torch.float32, []),
            ("bfloat16", BF16, ["--dtype", "bfloat16"]),
            ("int8_bfloat16", BF16, ["--dtype", "bfloat16", "--quant", "int8",
                                     "--quant_min_channels", str(QUANT_MIN_CHANNELS)])):
        out, outputs = os.path.join(workdir, f"enhanced_dc3_{config}"), {}
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "storm", "--timeit", "--device", "cuda",
                                    "--N", str(N_STEPS), "--deepcache", str(DC_K), *extra],
                                   outputs)
        per_file = [(k1, k3) for k1, k3, _ in per_call]
        check_outputs(out, lengths)
        quant = scales if "int8" in config else None
        check(quant is None or f"int8 scales loaded from {scale_cache_path(ckpt)}" in text,
              f"{config}: the dc3 run did not load phase 19's scales")
        want = dc_call_launches(N_STEPS, 2, quant)
        path = f"enhancement_dc3_{config}"
        k1_paths[path], k3_paths[path] = (kup.upfirdn2d_cuda.launches,
                                          kq.quantize_int8_cuda.launches)
        rtf, (exact_rtf, exact_out) = rtf_of(text), exact[config]
        rel = relative_to(outputs, exact_out)
        for name in lengths:
            print(f"  {config} dc3 {name}: RTF {rtf[name]:.4f} against exact "
                  f"{exact_rtf[name]:.4f} ({exact_rtf[name] / rtf[name]:.2f}x); "
                  f"max|dc3 - exact| / max|exact| = {rel[name]:.4e}", flush=True)
        print(f"  {config} dc3: launches per file (K1, K3) {per_file}, expected {want} (exact: "
              f"({K1_PER_FORWARD * NFE}, {K3_PER_FILE if quant else 0}))", flush=True)
        check(per_file == [want] * len(lengths), f"{config} dc3: launches per file {per_file}")
        check(all(np.isfinite(v).all() for v in outputs.values()), f"{config} dc3: not finite")
        check({s[-1] for s in k1s} == {dtype}, f"{config} dc3 gave upfirdn2d {k1s}")
        k1_shapes |= k1s
        k3_shapes |= k3s
    check({(d, p) for _, d, p in k3_shapes} == {(BF16, BF16)},
          f"the int8 bf16 dc3 run's quantizer inputs {k3_shapes}")
    f32_err, bf16_err = (check_k1_at(f"the {what} dc3 CLI runs",
                                     {s for s in k1_shapes if s[-1] == dtype}, gen)
                         for what, dtype in (("float32", torch.float32), ("bf16", BF16)))
    return (k1_paths, k3_paths, f32_err, bf16_err,
            check_k3_at("the int8 bf16 dc3 run", k3_shapes, gen))


LOAD_REQUESTS, LOAD_CLIENTS, LOAD_BATCH = 48, 16, 8  # `serve_load` against the dc3 bf16 server


def run_load(what: str, args, load_dir: str):
    """Build the server in this process and drive it with `python -m
    storm_tpu_torch.serve_load` (LOAD_REQUESTS requests of the files in
    `load_dir` from LOAD_CLIENTS closed-loop clients, after its own warm
    request); returns (its report, the server's /stats, K1 launches from the
    build on, the K1 shapes they ran at)."""
    from storm_tpu_torch import serve_load

    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, _):
        (httpd, batcher), _ = captured(serve.build_server, args)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = httpd.server_address[:2]
            report, _ = captured(serve_load.main, [
                "--url", f"http://{host}:{port}", "--dir", load_dir, "--requests",
                str(LOAD_REQUESTS), "--concurrency", str(LOAD_CLIENTS)])
            stats = json.loads(http_call(host, port, "GET", "/stats")[2])
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(timeout=60)
        torch.cuda.synchronize()
    check(not thread.is_alive(), f"{what}: the server thread did not stop")
    return report, stats, kup.upfirdn2d_cuda.launches, k1_shapes


def phase_deepcache_server(workdir: str, gen: torch.Generator):
    """Phase 31. The server at --deepcache 3 in its default dtype (bf16) on
    phase 15's burst, then int8 + bf16 (phase 15's scales, loaded); /healthz
    reports deepcache and its depth. Then `python -m storm_tpu_torch.serve_load`
    against a bf16 dc3 server of --batch 8. Returns ({path: K1 launches},
    {path: K3 launches}, K1 error, K3 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    dc = ["--deepcache", str(DC_K), "--deepcache_depth", str(DC_DEPTH)]
    ckpt8 = os.path.join(workdir, "storm_serve.pt")
    scales = quant_mod.load_scales(scale_cache_path(ckpt8))
    k1_paths, k3_paths, k1_shapes, k3_shapes = {}, {}, set(), set()
    for path, args, n, quant in (
            ("server_dc3_bf16", serve_args(os.path.join(workdir, "storm.pt"), *dc), None, None),
            ("server_int8_dc3_bf16", serve_args(ckpt8, "--quant", "int8", *dc), INT8_REQUESTS,
             scales)):
        r = run_server(path, args, waves[:n])
        health = r["health"]
        check(health["deepcache"] == DC_K and health["deepcache_depth"] == DC_DEPTH,
              f"{path}: /healthz reports deepcache {health.get('deepcache')}, depth "
              f"{health.get('deepcache_depth')}")
        check(quant is None or "int8 scales loaded" in r["build_text"],
              f"{path}: the scales were not loaded")
        calls = r["warmups"] + r["stats"]["batches"]
        per_call = dc_call_launches(SERVE_N, 2, quant)
        want = (per_call[0] * calls, per_call[1] * calls)
        print(f"  {path}: launches (K1, K3) {(r['k1'], r['k3'])}, expected {per_call} x "
              f"({r['warmups']} warm-up + {r['stats']['batches']} batches) = {want}", flush=True)
        check((r["k1"], r["k3"]) == want, f"{path}: launches {(r['k1'], r['k3'])}")
        check({s[-1] for s in r["k1_shapes"]} == {BF16}, f"{path} ran upfirdn2d in float32")
        k1_paths[path], k3_paths[path] = r["k1"], r["k3"]
        k1_shapes |= r["k1_shapes"]
        k3_shapes |= r["k3_shapes"]

    load_dir = os.path.join(workdir, "load_noisy")
    write_named_wavs(load_dir, SERVE_SECONDS, "load", seed=4)
    path = "serve_load_dc3_bf16"
    report, stats, k1, load_shapes = run_load(path, serve_args(os.path.join(workdir, "storm.pt"), *dc,
                                                  "--batch", str(LOAD_BATCH)), load_dir)
    config = report["server_config"]
    warmups = len(config["warmup_buckets_s"]) * len(config["row_sizes"])
    want = dc_call_launches(SERVE_N, 2)[0] * (warmups + stats["batches"])
    print(f"  {path}: {json.dumps(report)}", flush=True)
    print(f"  {path}: upfirdn2d launches {k1}, expected {dc_call_launches(SERVE_N, 2)[0]} x "
          f"({warmups} warm-up + {stats['batches']} batches) = {want}", flush=True)
    check(report["requests"] == LOAD_REQUESTS and report["errors"] == 0
          and stats["requests"] == LOAD_REQUESTS + 1 and stats["errors"] == 0
          and config["deepcache"] == DC_K and config["dtype"] == "bfloat16",
          f"{path}: report {report}, /stats {stats}")
    check(k1 == want, f"{path}: upfirdn2d launched {k1}, expected {want}")
    check({s[-1] for s in load_shapes} == {BF16}, f"{path} ran upfirdn2d in float32")
    k1_paths[path] = k1
    return (k1_paths, k3_paths,
            check_k1_at("the dc3 servers and serve_load's", k1_shapes | load_shapes, gen),
            check_k3_at("the int8 bf16 dc3 server", k3_shapes, gen))


def phase_bench(workdir: str, gen: torch.Generator):
    """Phase 32. `python -m storm_tpu_torch.bench` at bench.py's defaults
    (B=16, 256 frames, bf16, int8, dc3, ald) but N=BENCH_N, with BENCH_REPS
    timed reps and its extras' budget at 0 s (the headline line alone: the N=30
    and exact extras are None), then `--train`: their JSON lines, printed;
    the serving run's K1 and K3 launches held to the counts of its calls
    (int8 calibration, the headline), the train run's to 36 + 33 per
    step; every K1 shape and K3 input the runs gave against plain, and the
    adjoint at every shape the train run's backward gave it. Returns
    ({path: K1 launches}, {path: K3 launches}, the train run's K1-bwd
    launches, the two lines, K1 error, K3 error, K1-bwd error)."""
    from storm_tpu_torch import bench

    scales = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    lines, k1_paths, k3_paths, k1_shapes, k3_shapes = {}, {}, {}, set(), set()
    for path, extra in (("bench_serving", ["--N", str(BENCH_N)]), ("bench_train", ["--train"])):
        torch.cuda.empty_cache()
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        kup.upfirdn2d_bwd_cuda.launches = 0
        t0 = time.perf_counter()
        with shapes_recorded() as (k1s, k3s), adjoint_shapes_recorded() as bwds, \
                mock.patch.dict(os.environ, {bench.BUDGET_ENV: "0"}):
            _, text = captured(bench.main, ["--reps", str(BENCH_REPS), *extra])
        wall = time.perf_counter() - t0
        line = json.loads(text.strip().splitlines()[-1])
        lines[path] = line
        d = line["detail"]
        calls = 1 + BENCH_REPS  # a warm-up call (eager, then the capture), then the timed reps
        if path == "bench_train":  # the eager steps (one untimed), then the program's (two untimed)
            steps = 1 + BENCH_REPS * 5 + 2 + BENCH_REPS * 5
            want = (STEP_FWD * steps, 0, STEP_BWD * steps)
            check(line["metric"] == "train_utt_per_sec_per_chip", f"{path}: {line}")
        else:
            check(line["metric"] == "audio_sec_per_sec_per_chip_50step_pc"
                  and d["nfe"] == 1 + 2 * BENCH_N
                  and d["exact_nfe101_audio_sec_per_sec"] is None
                  and d["storm_default_nfe31_audio_sec_per_sec"] is None,
                  f"{path}: {line}")
            k1_h, k3_h = dc_call_launches(BENCH_N, 2, scales)
            want = (K1_PER_FORWARD * calib_forwards(min(BENCH_N, 10), probes=4) + calls * k1_h,
                    calls * k3_h, 0)
        got = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches,
               kup.upfirdn2d_bwd_cuda.launches)
        print(f"  {path}: {wall:.1f} s wall; launches (K1, K3, K1-bwd) {got}, expected {want}",
              flush=True)
        check(got == want, f"{path}: launches {got}, expected {want}")
        check({s[-1] for s in k1s} == {BF16}, f"{path} gave upfirdn2d {k1s}")
        train_run = path == "bench_train"
        check({(s[0], *s[2:5]) for s in bwds} == (set(k1_bwd_calls()) if train_run else set())
              and {s[1] for s in bwds} <= {16} and {s[-1] for s in bwds} <= {BF16},
              f"{path} gave upfirdn2d's adjoint {sorted(bwds, key=str)}")
        k1_paths[path], k3_paths[path], bwd = got
        k1_shapes |= k1s
        k3_shapes |= k3s
        bwd_shapes = bwds if train_run else None
    print(f"  bench line: {json.dumps(lines['bench_serving'])}", flush=True)
    d = lines["bench_train"]["detail"]
    print(f"  bench --train line: {json.dumps(lines['bench_train'])}; the replayed step "
          f"{d['step_ms']} ms ({lines['bench_train']['value']} utt/s) against the eager "
          f"{d['eager_step_ms']} ms ({d['eager_utt_per_sec']} utt/s)", flush=True)
    return (k1_paths, k3_paths, bwd, lines, check_k1_at("the bench", k1_shapes, gen),
            check_k3_at("the bench", k3_shapes, gen),
            check_k1_bwd_at("the bench --train", bwd_shapes, gen))


def phase_profile_dc3_bf16():
    """Phase 33: trace one dc3 bfloat16 enhancement of the 4 s file (CLI defaults)."""
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=4, corrector="ald", deepcache=DC_K)  # warm-up at the same shapes
    profile_run(f"dc3 bf16 enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=DEFAULT_N, corrector="ald", deepcache=DC_K),
                BF16_GROUPS)


def phase_profile_bench():
    """Phase 34: trace one enhance call at bench.py's defaults (B=16 random
    utterances of 256 frames, N=50 + ald, bf16, dc3), with int8 scales
    calibrated as the bench calibrates them, then without int8."""
    model = build_model({"mode": "regen-joint-training", "dtype": "bfloat16"}, device="cuda",
                        seed=0)
    y = torch.from_numpy((np.random.default_rng(0).standard_normal((16, 255 * HOP)) * 0.1)
                         .astype(np.float32)).cuda()
    quant = quant_mod.calibrate_storm(model, y[:4], N=min(DEFAULT_N, 10), num_probe=4,
                                      generator=torch.Generator(device="cuda").manual_seed(7))
    for name, q in (("int8 + bf16", quant), ("bf16", None)):
        model.enhance(y, N=4, corrector="ald", quant=q, deepcache=DC_K)  # warm-up
        profile_run(f"bench call, {name}, dc3 (B=16, {FREQS} x {TRAIN_FRAMES})",
                    lambda: model.enhance(y, N=DEFAULT_N, corrector="ald", quant=q,
                                          deepcache=DC_K)[0].cpu(),
                    {**BF16_GROUPS, **INT8_GROUPS,
                     # the int8 conv's im2col; the skips' cat is the _vectorized kernel
                     "int8 im2col (torch.stack)": (("CatArrayBatchedCopy<",), None)})


# --- the probability-flow samplers and the test-set evaluation (phases 35-39)

ODE_METHOD = "etd2"  # the CLI's default ODE method
ODE_NFE = 1 + 2 * N_STEPS + 1  # the denoiser, 2 per step, the final denoising step: 10
ODE_N = 4  # phases 37-44
ODE_N_NFE = 1 + 2 * ODE_N + 1  # 10
PER_STEP = {"euler": 1, "heun": 2, "rk4": 4, "etd1": 1}
PICARD_SWEEPS = 4
RK45_TOL = "1e-3"  # looser than the CLI's default, 1e-5 (59 attempted steps on these weights)
# phase 36's N: each of its eleven CLI runs enhances one file (the eager loop)
METHODS_N = 4
TRAJECTORY_RTOL = 1e-4  # the f32 ODE through the kernels against plain, of the output's scale
EVAL_BATCH = 4
EVAL_SI_SDR_ATOL_DB = 1e-4


@contextlib.contextmanager
def calls_counted():
    """While active, every call a `BucketedEnhancer` makes of its model (a
    shape's first call, the eager loop; its second, which also captures; a
    replay; or an eager call) adds (its K1 launches, its K3 launches, the
    NFE it reports) to the yielded list."""
    per_call = []
    original = BucketedEnhancer._enhance

    def counted(enhancer, *args, **kwargs):
        before = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
        result = original(enhancer, *args, **kwargs)
        per_call.append((kup.upfirdn2d_cuda.launches - before[0],
                         kq.quantize_int8_cuda.launches - before[1], int(result[1])))
        return result

    with mock.patch.object(BucketedEnhancer, "_enhance", counted):
        yield per_call


def ode_dc_launches(n_steps: int = ODE_N) -> int:
    """K1 launches of one B=1 etd2 call with --deepcache DC_K: the
    denoiser, a deep pass at x(T) and at each refresh, one shallow pass per
    evaluation (2 per step), and the final denoising step's full forward."""
    return dc_call_launches(n_steps, 2)[0] + K1_PER_FORWARD


def glob_wavs(directory: str):
    return [os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".wav")]


def phase_ode_cli(workdir: str, lengths, exact, gen: torch.Generator):
    """Phase 35. `python -m storm_tpu_torch.enhancement --sampler ode` on phase
    5's three files at the CLI's defaults for it (etd2, N=50: 102 forwards
    per file) in float32, bf16 and --quant int8 --dtype bfloat16 (phase 19's
    scales, loaded): outputs finite and of their lengths, per file exactly
    18 x 102 K1 and, int8, 55 x 102 K3 launches, the RTF beside pc's (phases
    5 and 19: `exact`), every K1 shape and K3 input against plain. Then the
    4 s file's f32 trajectory through the kernels against the plain path,
    same prior, cuDNN deterministic. Returns ({path: K1 launches}, {path: K3
    launches}, K1's f32 and bf16 errors, K3's error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "noisy")
    k1_paths, k3_paths, k1_shapes, k3_shapes = {}, {}, set(), set()
    for config, dtype, extra in (
            ("float32", torch.float32, []),
            ("bfloat16", BF16, ["--dtype", "bfloat16"]),
            ("int8_bfloat16", BF16, ["--dtype", "bfloat16", "--quant", "int8",
                                     "--quant_min_channels", str(QUANT_MIN_CHANNELS)])):
        out, outputs = os.path.join(workdir, f"enhanced_ode_{config}"), {}
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "storm", "--timeit", "--device", "cuda",
                                    "--N", str(N_STEPS), "--sampler", "ode", *extra], outputs)
        check_outputs(out, lengths)
        quant = "int8" in config
        check(not quant or f"int8 scales loaded from {scale_cache_path(ckpt)}" in text,
              f"{config}: the ODE run did not load phase 19's scales")
        want = (K1_PER_FORWARD * ODE_NFE, N_QUANT * ODE_NFE if quant else 0, ODE_NFE)
        path = f"enhancement_ode_{config}"
        k1_paths[path], k3_paths[path] = (kup.upfirdn2d_cuda.launches,
                                          kq.quantize_int8_cuda.launches)
        rtf, (pc_rtf, pc_out) = rtf_of(text), exact[config]
        rel = relative_to(outputs, pc_out)
        for name in lengths:
            print(f"  {config} ode {ODE_METHOD} N={N_STEPS} {name}: RTF {rtf[name]:.4f} against "
                  f"pc {pc_rtf[name]:.4f} (N={N_STEPS} + ald, {NFE} NFE); max|ode - pc| / "
                  f"max|pc| = {rel[name]:.4e} (random weights: a reading)", flush=True)
        print(f"  {config} ode: (K1, K3, NFE) per file {per_call}, expected {want}", flush=True)
        check(per_call == [want] * len(lengths), f"{config} ode: per file {per_call}")
        check({s[-1] for s in k1s} == {dtype}, f"{config} ode gave upfirdn2d {k1s}")
        k1_shapes |= k1s
        k3_shapes |= k3s
    check({(d, p) for _, d, p in k3_shapes} == {(BF16, BF16)},
          f"the int8 bf16 ode run's quantizer inputs {k3_shapes}")
    f32_err, bf16_err = (check_k1_at(f"the {what} ode CLI runs",
                                     {s for s in k1_shapes if s[-1] == dtype}, gen)
                         for what, dtype in (("float32", torch.float32), ("bf16", BF16)))
    k3_err = check_k3_at("the int8 bf16 ode run", k3_shapes, gen)

    # an ODE is deterministic past its prior draw: one whole trajectory (at
    # N=DEPTH_N: 22 forwards) through the kernels against the plain path
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    name = max(lengths, key=lengths.get)
    y = bucketed(load_wav(os.path.join(noisy, name))[0])
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for plain in (False, True):
            ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
                   else contextlib.nullcontext())
            with ctx:
                runs.append(model.enhance(y, N=DEPTH_N, sampler_type="ode", method=ODE_METHOD,
                                          generator=torch.Generator(device="cuda").manual_seed(0)))
    finally:
        torch.backends.cudnn.deterministic = False
    (got, nfe), (want, _) = runs
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"  f32 ode {ODE_METHOD} trajectory ({name}, {nfe} forwards) through the kernels "
          f"against plain: max abs err {err:.3e} (scale {scale:.3e}, "
          f"{err / scale:.3e} of it)", flush=True)
    check(nfe == 2 * DEPTH_N + 2 and err <= TRAJECTORY_RTOL * scale,
          f"the f32 ODE trajectory through the kernels parts from plain by {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return k1_paths, k3_paths, max(f32_err, err), bf16_err, k3_err


def phase_ode_methods(workdir: str, gen: torch.Generator):
    """Phase 36. Every sampler of the CLI at the 4 s bucket in bf16,
    N=METHODS_N, one file a call: the fixed-step ODE methods, etd2 with --deepcache 3, rk45
    (its accepted and attempted steps counted in the loop), picard
    (--sweeps 4; the 1 s and 4 s files, its peak memory) and pc with the etd
    predictor. K1 launches per call derived from N, the method and the
    module list, or for rk45 from the drift evaluations counted in the
    loop, not from the NFE the run reports; the reported NFE held to its
    own count (the forwards, less deepcache's refreshes, which it does not
    count); K1 against plain at every shape. Returns ({path: K1 launches},
    K1's error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    dirs = {s: os.path.join(workdir, f"ode_{s:.0f}s") for s in (1.0, 4.0)}
    for s, d in dirs.items():
        write_named_wavs(d, (s,), "ode", seed=6)
    base = ["--ckpt", ckpt, "--mode", "storm", "--timeit", "--device", "cuda", "--dtype",
            "bfloat16", "--N", str(METHODS_N)]
    ode = ["--sampler", "ode", "--ode-method"]
    def forwards(n):  # (K1 launches, NFE) of n full forwards
        return K1_PER_FORWARD * n, n

    # (path, seconds, flags, K1 launches, NFE); None: rk45's, from its loop
    cases = [(f"ode_{m}", 4.0, ode + [m], *forwards(1 + METHODS_N * k + 1))
             for m, k in PER_STEP.items()]
    etd2_nfe = 1 + 2 * METHODS_N + 1
    cases += [("ode_etd2", 4.0, ode + ["etd2"], *forwards(etd2_nfe)),
              ("ode_etd2-ms", 4.0, ode + ["etd2-ms"], *forwards(1 + METHODS_N + 1 + 1)),
              ("ode_etd2_dc3", 4.0, ode + ["etd2", "--deepcache", str(DC_K)],
               ode_dc_launches(METHODS_N), etd2_nfe),
              ("ode_rk45", 4.0, ode + ["rk45", "--rtol", RK45_TOL, "--atol", RK45_TOL], None,
               None),
              ("pc_etd", 4.0, ["--predictor", "etd"], *forwards(1 + 2 * METHODS_N))]
    # one wide forward per sweep: the NFE counts each sweep's N grid points
    cases += [(f"picard_{s:.0f}s", s, ["--sampler", "picard", "--sweeps", str(PICARD_SWEEPS)],
               K1_PER_FORWARD * (PICARD_SWEEPS + 2), 1 + PICARD_SWEEPS * METHODS_N + 1)
              for s in (1.0, 4.0)]
    real_dopri = samplers.dopri45_integrate
    loops = []

    def dopri_counted(drift_fn, x0, t0, t1, **kw):
        evals = [0]

        def drift(x, t):
            evals[0] += 1
            return drift_fn(x, t)

        result = real_dopri(drift, x0, t0, t1, **kw)
        loops.append((evals[0], result[2]))
        return result

    k1_paths, shapes = {}, set()
    for path, seconds, flags, want, want_nfe in cases:
        out = os.path.join(workdir, f"enhanced_{path}")
        kup.upfirdn2d_cuda.launches = 0
        loops.clear()
        torch.cuda.reset_peak_memory_stats()
        with shapes_recorded() as (k1s, _), calls_counted() as per_call, \
                mock.patch.object(samplers, "dopri45_integrate", dopri_counted):
            text = run_enhancement(["--test_dir", dirs[seconds], "--enhanced_dir", out, *base,
                                    *flags])
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_outputs(out, {os.path.basename(f): load_wav(f)[0].shape[-1]
                            for f in sorted(glob_wavs(dirs[seconds]))})
        extra = ""
        if want is None:  # rk45: from the drift evaluations counted in its loop
            (evals, accepted), = loops
            attempted = (evals - 2) // 6
            want, want_nfe = forwards(1 + evals + 1)
            extra = (f"; rtol = atol = {RK45_TOL}: {accepted} accepted of {attempted} attempted "
                     f"steps, {evals} drift evaluations")
            check(evals == 2 + 6 * attempted and accepted <= attempted,
                  f"{path}: {evals} evaluations, {accepted} accepted")
        (k1, _, nfe), = per_call
        rtf = list(rtf_of(text).values())[0]
        print(f"  {path} ({seconds:.0f} s, bf16, N={METHODS_N}): RTF {rtf:.4f}, NFE {nfe} "
              f"(expected {want_nfe}), K1 launches {k1} (expected {want}), peak memory "
              f"{peak:.2f} GiB{extra}", flush=True)
        check(k1 == want, f"{path}: K1 launched {k1}, expected {want}")
        check(nfe == want_nfe, f"{path}: NFE {nfe}, expected {want_nfe}")
        check({s[-1] for s in k1s} == {BF16}, f"{path} gave upfirdn2d {k1s}")
        k1_paths[f"{path}_bf16"] = k1
        shapes |= k1s
    rows = sorted({s[1] for s in shapes})
    check(METHODS_N in rows, f"picard gave upfirdn2d no {METHODS_N}-row call: {rows}")
    return k1_paths, check_k1_at("the sampler runs", shapes, gen)


def phase_ode_server(workdir: str, gen: torch.Generator):
    """Phase 37. The server with --sampler ode (etd2, N=SERVE_N) at its
    default dtype, bf16, then with --deepcache 3, on phase 15's burst: every
    reply 200 with X-NFE 2 N + 2, /healthz's sampler and ode_method, exact K1 launches
    per warm-up call and batch, K1 against plain at every shape. Returns
    ({path: K1 launches}, K1's error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    k1_paths, shapes = {}, set()
    nfe = 1 + 2 * SERVE_N + 1
    for path, extra, per_call in (
            ("server_ode_bf16", [], K1_PER_FORWARD * nfe),
            ("server_ode_dc3_bf16", ["--deepcache", str(DC_K)], ode_dc_launches(SERVE_N))):
        r = run_server(path, serve_args(ckpt, "--sampler", "ode", *extra), waves, nfe=nfe)
        health = r["health"]
        check((health["sampler"], health["ode_method"]) == ("ode", ODE_METHOD),
              f"{path}: /healthz reports {health.get('sampler')}, {health.get('ode_method')}")
        calls = r["warmups"] + r["stats"]["batches"]
        rows = sorted({s[1] for s in r["k1_shapes"]})
        want = per_call * calls
        print(f"  {path}: upfirdn2d launches {r['k1']}, expected {per_call} x ({r['warmups']} "
              f"warm-up + {r['stats']['batches']} batches) = {want}; batch rows {rows}",
              flush=True)
        check(r["k1"] == want and r["k3"] == 0, f"{path}: launches {r['k1']}, {r['k3']}")
        check({s[-1] for s in r["k1_shapes"]} == {BF16}, f"{path} ran upfirdn2d in float32")
        k1_paths[path] = r["k1"]
        shapes |= r["k1_shapes"]
    return k1_paths, check_k1_at("the ode servers", shapes, gen)


def phase_ode_streaming(workdir: str, gen: torch.Generator):
    """Phase 38. Streaming with --sampler ode --N ODE_N on phase 16's 12 s file
    (float32, the checkpoint's): per call of 8 chunks exactly 18 x ODE_N_NFE K1
    launches. Returns (K1 launches, K1's error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "stream_noisy"), os.path.join(workdir, "stream_ode")
    lengths = {os.path.basename(f): load_wav(f)[0].shape[-1] for f in glob_wavs(noisy)}
    T = next(iter(lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    calls = -(-len(range(0, T - overlap, chunk - overlap)) // STREAM_ROWS)
    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (k1s, _), calls_counted() as per_call:
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--N", str(ODE_N), "--sampler", "ode",
                                "--stream_chunk_s", str(STREAM_CHUNK_S), "--stream_overlap_s",
                                str(STREAM_OVERLAP_S), "--timeit", "--device", "cuda"])
    launches = kup.upfirdn2d_cuda.launches
    check_outputs(out, lengths)
    want = [(K1_PER_FORWARD * ODE_N_NFE, 0, ODE_N_NFE)] * calls
    print(f"  streaming ode: RTF {list(rtf_of(text).values())}; (K1, K3, NFE) per call of "
          f"{STREAM_ROWS} chunks {per_call}, expected {want[0]} x {calls}", flush=True)
    check(per_call == want, f"streaming ode: per call {per_call}")
    return launches, check_k1_at("streaming ode", k1s, gen)


def write_test_split(corpus: str):
    """`tt` of the wsj0 layout beside phase 8's corpus: pairs at
    BATCH_SECONDS (two buckets of four), {name: samples}."""
    if os.path.isdir(os.path.join(corpus, "tt")):
        return
    rng = np.random.default_rng(7)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(corpus, "tt", kind))
    for i, s in enumerate(BATCH_SECONDS):
        clean = synth_wav(s, i, rng)
        noisy = clean + 0.1 * rng.standard_normal(clean.shape[-1]).astype(np.float32)
        save_wav(os.path.join(corpus, "tt", "clean", f"t{i:02d}.wav"), clean, SR)
        save_wav(os.path.join(corpus, "tt", "noisy", f"t{i:02d}.wav"), noisy, SR)


def served_si_sdr(model, corpus: str, sampler: str):
    """{file: SI-SDR} of the test split enhanced through BucketedEnhancer as
    the evaluation CLI groups it: by padded length, shortest bucket first,
    EVAL_BATCH rows a call, one generator seeded with 0."""
    test_set = Specs(corpus, "test")
    kw = dict(sampler_type="ode", method=ODE_METHOD) if sampler == "ode" else {}
    enh = BucketedEnhancer(model, minibatch=EVAL_BATCH, N=ODE_N, corrector="ald", **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    items = [test_set.__getitem__(i, raw=True) for i in range(len(test_set))]
    groups = {}
    for i, (_, y) in enumerate(items):
        groups.setdefault(enh.padded_len(y.shape[-1]), []).append(i)
    scores = {}
    for L, idxs in sorted(groups.items()):
        for s in range(0, len(idxs), EVAL_BATCH):
            group = idxs[s: s + EVAL_BATCH]
            ys = np.stack([np.pad(items[i][1][0], (0, L - items[i][1].shape[-1])) for i in group])
            x_hats, _ = enh(ys, gen)
            for j, i in enumerate(group):
                scores[os.path.basename(test_set.clean_files[i])] = si_sdr(
                    items[i][0][0], x_hats[j][: items[i][1].shape[-1]])
    return scores


def phase_evaluate(workdir: str):
    """Phase 39. `python -m storm_tpu_torch.evaluate --mode storm` on a test
    split of 8 pairs beside phase 8's corpus, --batch 4 --N ODE_N --csv, with
    pc and then --sampler ode, on phase 5's checkpoint: 8 CSV rows, SI-SDR
    and ESTOI finite, PESQ NaN unless `pesq` imports, the mean +/- CI
    lines; exactly 18 x NFE K1 launches per enhancer call; each row's
    SI-SDR that of BucketedEnhancer's output for the same file, grouping
    and seed (cuDNN deterministic); the metrics' wall time beside the
    enhancement's. Returns {path: K1 launches}."""
    corpus = os.path.join(workdir, "train", "corpus")
    write_test_split(corpus)
    ckpt = os.path.join(workdir, "storm.pt")
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    k1_paths = {}
    timers = {"enhance": 0.0, "metrics": 0.0}

    def timed(kind, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timers[kind] += time.perf_counter() - t0
        return run

    real_call = BucketedEnhancer.__call__
    torch.backends.cudnn.deterministic = True
    try:
        for sampler, nfe in (("pc", 1 + 2 * ODE_N), ("ode", ODE_N_NFE)):
            out_csv = os.path.join(workdir, f"evaluate_{sampler}.csv")
            timers.update(enhance=0.0, metrics=0.0)
            kup.upfirdn2d_cuda.launches = 0
            with calls_counted() as per_call, \
                    mock.patch.object(BucketedEnhancer, "__call__", timed("enhance", real_call)), \
                    mock.patch.object(evaluate, "pesq_wb", timed("metrics", evaluate.pesq_wb)), \
                    mock.patch.object(evaluate, "si_sdr", timed("metrics", evaluate.si_sdr)), \
                    mock.patch.object(evaluate, "stoi", timed("metrics", evaluate.stoi)):
                t0 = time.perf_counter()
                text = captured(evaluate.main, [
                    "--ckpt", ckpt, "--mode", "storm", "--base_dir", corpus, "--num_files",
                    str(len(BATCH_SECONDS)), "--batch", str(EVAL_BATCH), "--N", str(ODE_N),
                    "--csv", out_csv, "--sampler", sampler, "--device", "cuda"])[1]
                wall = time.perf_counter() - t0
            # read before served_si_sdr's own enhancer calls launch K1 again
            k1_paths[f"evaluate_{sampler}"] = kup.upfirdn2d_cuda.launches
            with open(out_csv) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == len(BATCH_SECONDS), f"evaluate {sampler}: {len(rows)} CSV rows")
            check(all(np.isfinite(float(r["si_sdr"])) and np.isfinite(float(r["estoi"]))
                      for r in rows), f"evaluate {sampler}: metrics not finite: {rows}")
            check(all(np.isnan(float(r["pesq"])) != pesq_available() for r in rows),
                  f"evaluate {sampler}: PESQ {[r['pesq'] for r in rows]}")
            check("--- mean +/- 95% CI ---" in text and all(
                re.search(rf"^{m}: \S+ \+/- \S+$", text, re.M) for m in ("pesq", "si_sdr", "estoi")),
                f"evaluate {sampler}: no mean +/- CI lines")
            check(len(per_call) == 2 and all(k1 == K1_PER_FORWARD * n and n == nfe
                                             for k1, _, n in per_call)
                  and k1_paths[f"evaluate_{sampler}"] == sum(k1 for k1, _, _ in per_call),
                  f"evaluate {sampler}: (K1, K3, NFE) per call {per_call}, K1 in all "
                  f"{k1_paths[f'evaluate_{sampler}']}")
            served = served_si_sdr(model, corpus, sampler)
            diffs = {r["file"]: abs(float(r["si_sdr"]) - served[r["file"]]) for r in rows}
            print(f"  evaluate --sampler {sampler}: {len(rows)} rows in {wall:.2f} s wall "
                  f"(enhancement {timers['enhance']:.2f} s, metrics on the host "
                  f"{timers['metrics']:.2f} s); (K1, K3, NFE) per call {per_call}; "
                  f"mean SI-SDR {np.mean([float(r['si_sdr']) for r in rows]):.3f} dB, ESTOI "
                  f"{np.mean([float(r['estoi']) for r in rows]):.4f}; |CSV SI-SDR - served| "
                  f"up to {max(diffs.values()):.2e} dB", flush=True)
            check(max(diffs.values()) <= EVAL_SI_SDR_ATOL_DB,
                  f"evaluate {sampler}: SI-SDR parts from the enhancer's by {diffs}")
    finally:
        torch.backends.cudnn.deterministic = False
    del model
    torch.cuda.empty_cache()
    return k1_paths


# --- the score-only and denoiser-only models and the OUVP SDE (phases 40-44)

SINGLE_MODES = ("score-only", "denoiser-only")
# NCSN++ forwards per file at the CLI's pc + ald, N=DEPTH_N: the score
# model's N x 2 (no denoiser), the denoiser's one
CLI_FORWARDS = {"score-only": 2 * DEPTH_N, "denoiser-only": 1}
OUVP_FLAGS = ("--sde", "ouvp")
OUVP_ODE_METHOD = "heun"
ETD_OUVP_REFUSAL = "etd2 requires an SDE with constant linear drift (OUVE); got OUVPSDE"
INT8_FLAGS = ["--dtype", "bfloat16", "--quant", "int8", "--quant_min_channels",
              str(QUANT_MIN_CHANNELS)]


def link_ckpt(workdir: str, src: str, name: str) -> str:
    """`src` hard-linked at workdir/name, so that its int8 scale cache is its own."""
    dst = os.path.join(workdir, name)
    if not os.path.exists(dst):
        os.link(src, dst)
    return dst


def served_model(ckpt: str):
    """The checkpoint's model on the card with its EMA weights, as the CLIs
    serve it (the config's dtype)."""
    c = load_training_checkpoint(ckpt)
    model = build_model(c["config"], device="cuda")
    model.load_state_dict(c["ema_params"], strict=True)
    return model


def single_dc_launches(mode: str, n_steps: int, evals_per_step: int, k: int = DC_K) -> int:
    """K1 launches of one score-only call with deepcache k, read from the
    net's module list: a deep pass at the prior and at each refresh, a
    shallow pass per score evaluation (no denoiser)."""
    k1, _ = per_pass(single_net_structure(mode))
    return deep_passes(n_steps, k) * k1["deep"] + n_steps * evals_per_step * k1["shallow"]


def phase_train_new_modes(train_dir: str, gen: torch.Generator, storm_f32, storm_bf16):
    """Phase 40. One full-width f32 score-only step's gradients against the
    plain path; then `python -m storm_tpu_torch.train` on phase 8's corpus,
    B=8, 256 frames, one epoch of 4 steps: --mode score-only and --mode
    denoiser-only --loss_type sisdr in f32 with the evaluation
    (--num_eval_files 4 --eval_N 4), --mode score-only and --mode
    regen-joint-training --sde ouvp in bf16 without it. phase_train's
    checks hold each (exact K1 launches per step from the module list,
    finite losses, SI-SDR and ESTOI where evaluated); the step and its peak
    memory beside StoRM's (phases 8 and 25) in the same dtype; K1 and its
    adjoint against plain at every shape the runs gave them. Returns
    ({run: phase_train's dict}, K1's f32 and bf16 errors, the adjoint's f32
    and bf16 errors)."""
    phase_train_gradients(gen, {"mode": "score-only", "init_scale": 1.0})
    runs = {}
    with adjoint_shapes_recorded() as bwd_shapes, shapes_recorded() as (k1s, _):
        for name, mode, dtype, extra, eval_files in (
                ("score-only", "score-only", "float32", (), VALID_FILES),
                ("score-only_bf16", "score-only", "bfloat16", (), 0),
                ("denoiser-only_sisdr", "denoiser-only", "float32", ("--loss_type", "sisdr"),
                 VALID_FILES),
                ("storm_ouvp_bf16", "regen-joint-training", "bfloat16", OUVP_FLAGS, 0)):
            r = phase_train(train_dir, dtype, steps_total=TRAIN_FILES // TRAIN_B,
                            eval_files=eval_files, eval_n=F32_EVAL_N, mode=mode, extra=extra)
            ref, phase = (storm_f32, 8) if dtype == "float32" else (storm_bf16, 25)
            print(f"  {name}: {step_launches(mode)} K1 launches per step; step "
                  f"{r['step_ms']:.2f} ms, peak of the steps {r['step_peak_gib']:.2f} GiB, "
                  f"against StoRM's {ref['step_ms']:.2f} ms and {ref['step_peak_gib']:.2f} GiB "
                  f"(phase {phase}, {dtype})", flush=True)
            runs[name] = r
    errs = []
    for where, dtype in (("f32", torch.float32), ("bf16", BF16)):
        errs.append(check_k1_at(f"the new modes' {where} training",
                                {s for s in k1s if s[-1] == dtype}, gen))
    for where, dtype in (("f32", torch.float32), ("bf16", BF16)):
        errs.append(check_k1_bwd_at(f"the new modes' {where} training",
                                    {s for s in bwd_shapes if s[-1] == dtype}, gen))
    return (runs, *errs)


def phase_new_modes_cli(workdir: str, ckpts, lengths, exact, gen: torch.Generator):
    """Phase 41. `python -m storm_tpu_torch.enhancement` with phase 40's f32
    score-only and denoiser-only checkpoints on phase 5's three files at the
    CLI's defaults (score-only: pc, N=50 + ald, 100 forwards per file; the
    denoiser one), in f32, bf16 and --quant int8 --dtype bfloat16 twice
    (calibrates, then loads the cache): per file exactly 18 K1 and, int8,
    55 K3 launches per forward, calibration's K1 in the first int8 run's
    total; the RTF beside StoRM's (phases 5 and 19); every K1 shape (the
    score net's 4-channel pyramid) and K3 input against plain. Then the 4 s
    file's score-only f32 etd2 ODE (N=ODE_N) and the denoiser's output through
    the kernels against the plain path, same prior, cuDNN deterministic.
    Returns ({path: K1}, {path: K3}, K1's f32 and bf16 errors, K3's)."""
    noisy = os.path.join(workdir, "noisy")
    k1_paths, k3_paths, k1_shapes, k3_shapes = {}, {}, set(), set()
    for mode in SINGLE_MODES:
        ckpt = link_ckpt(workdir, ckpts[mode], f"{mode}.pt")
        fw = CLI_FORWARDS[mode]
        for config, dtype, extra in (("float32", torch.float32, ["--dtype", "float32"]),
                                     ("bfloat16", BF16, ["--dtype", "bfloat16"]),
                                     ("int8_bfloat16", BF16, INT8_FLAGS),
                                     ("int8_bfloat16_cached", BF16, INT8_FLAGS)):
            out, outputs = os.path.join(workdir, f"enhanced_{mode}_{config}"), {}
            kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
            with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
                text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt",
                                        ckpt, "--mode", mode, "--N", str(DEPTH_N), "--timeit",
                                        "--device", "cuda", *extra], outputs)
            totals = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
            check_outputs(out, lengths)
            n_quant, calib = 0, 0
            if "int8" in config:
                cache = scale_cache_path(ckpt)
                n_quant = quant_mod.num_quantized_convs(quant_mod.load_scales(cache, True))
                check(n_quant == N_QUANT, f"{mode}: {n_quant} quantized convs")
                if config == "int8_bfloat16":
                    check(f"int8 calibration done ({N_QUANT} convs quantized" in text,
                          f"{mode}: the first int8 run did not calibrate")
                    calib = CALIB_FORWARDS - 1 if mode == "score-only" else 1
                else:
                    check(f"int8 scales loaded from {cache} ({N_QUANT} convs" in text,
                          f"{mode}: the second int8 run did not load the cache")
            want = (K1_PER_FORWARD * fw, n_quant * fw, fw)
            check(per_call == [want] * len(lengths),
                  f"{mode} {config}: (K1, K3, NFE) per file {per_call}, expected {want}")
            check(totals == (K1_PER_FORWARD * (fw * len(lengths) + calib),
                             n_quant * fw * len(lengths)), f"{mode} {config}: launches {totals}")
            check({s[-1] for s in k1s} == {dtype}, f"{mode} {config} gave upfirdn2d {k1s}")
            path = f"enhancement_{mode}_{config}"
            k1_paths[path], k3_paths[path] = totals
            k1_shapes |= k1s
            k3_shapes |= k3s
            rtf, storm_rtf = rtf_of(text), exact[config.replace("_cached", "")][0]
            print(f"  {mode} {config}: (K1, K3, NFE) per file {per_call[0]} x {len(lengths)}, "
                  f"in all {totals}" + (f" with {calib} calibration forwards" if calib else "")
                  + f"; RTF at N={DEPTH_N} " + ", ".join(
                      f"{n} {rtf[n]:.4f} (StoRM at N={N_STEPS}: {storm_rtf[n]:.4f})"
                      for n in lengths), flush=True)
    check({s[2] for s in k1_shapes if s[0] == "down" and s[3] == FREQS} >= {4, NF},
          "the score net's 4-channel input pyramid gave upfirdn2d no call")
    f32_err, bf16_err = (check_k1_at(f"the new modes' {what} CLI runs",
                                     {s for s in k1_shapes if s[-1] == dtype}, gen)
                         for what, dtype in (("float32", torch.float32), ("bf16", BF16)))
    k3_err = check_k3_at("the new modes' int8 bf16 runs", k3_shapes, gen)

    name = max(lengths, key=lengths.get)
    y = bucketed(load_wav(os.path.join(noisy, name))[0])
    errs = []
    torch.backends.cudnn.deterministic = True
    try:
        for mode, kw, nfe in (("score-only", dict(N=ODE_N, sampler_type="ode",
                                                  method=ODE_METHOD), 2 * ODE_N + 1),
                              ("denoiser-only", {}, 1)):
            model = served_model(os.path.join(workdir, f"{mode}.pt"))
            runs = []
            for plain in (False, True):
                ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
                       else contextlib.nullcontext())
                with ctx:
                    runs.append(model.enhance(
                        y, generator=torch.Generator(device="cuda").manual_seed(0), **kw))
            (got, n), (want_x, _) = runs
            err, scale = (got - want_x).abs().max().item(), want_x.abs().max().item()
            print(f"  {mode} f32 {kw.get('method', 'forward')} ({name}, {n} forwards) through "
                  f"the kernels against plain: max abs err {err:.3e} (scale {scale:.3e}, "
                  f"{err / scale:.3e} of it)", flush=True)
            check(n == nfe and err <= TRAJECTORY_RTOL * scale,
                  f"{mode}: the kernels' output parts from plain by {err:.3e}")
            errs.append(err)
            del model
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return k1_paths, k3_paths, max(f32_err, *errs), bf16_err, k3_err


def phase_ouvp_serving(workdir: str, ouvp_ckpt: str, lengths, exact, gen: torch.Generator):
    """Phase 42. Phase 40's OUVP StoRM checkpoint (bf16) through the CLI on
    phase 5's files: pc at N_STEPS + ald (NFE forwards per file)
    and --sampler ode --ode-method heun --N ODE_N (ODE_N_NFE), exact K1 launches per
    file, the RTF beside phase 19's; `--ode-method etd2` raises the
    reference's ValueError (a process running the CLI exits with status
    1); K1 against plain at every shape. Returns ({path: K1}, K1's error)."""
    ckpt = link_ckpt(workdir, ouvp_ckpt, "storm_ouvp.pt")
    noisy = os.path.join(workdir, "noisy")
    check(load_training_checkpoint(ckpt)["config"]["sde"] == "ouvp", "not an OUVP checkpoint")
    base = ["--test_dir", noisy, "--ckpt", ckpt, "--mode", "storm", "--timeit", "--device",
            "cuda"]
    k1_paths, shapes = {}, set()
    for path, extra, nfe in (("enhancement_ouvp_pc_bf16", ["--N", str(N_STEPS)], NFE),
                             ("enhancement_ouvp_ode_heun_bf16",
                              ["--sampler", "ode", "--ode-method", OUVP_ODE_METHOD, "--N",
                               str(ODE_N)], ODE_N_NFE)):
        out = os.path.join(workdir, path)
        kup.upfirdn2d_cuda.launches = 0
        with shapes_recorded() as (k1s, _), calls_counted() as per_call:
            text = run_enhancement([*base, "--enhanced_dir", out, *extra])
        check_outputs(out, lengths)
        want = (K1_PER_FORWARD * nfe, 0, nfe)
        check(per_call == [want] * len(lengths), f"{path}: per file {per_call}")
        check({s[-1] for s in k1s} == {BF16}, f"{path} gave upfirdn2d {k1s}")
        k1_paths[path] = kup.upfirdn2d_cuda.launches
        shapes |= k1s
        rtf = rtf_of(text)
        print(f"  {path}: (K1, K3, NFE) per file {per_call[0]} x {len(lengths)}; RTF "
              + ", ".join(f"{n} {rtf[n]:.4f}" for n in lengths)
              + (f" (OUVE StoRM bf16, phase 19: "
                 + ", ".join(f"{exact['bfloat16'][0][n]:.4f}" for n in lengths) + ")"
                 if not extra else ""), flush=True)
    try:
        run_enhancement([*base, "--enhanced_dir", os.path.join(workdir, "ouvp_etd2"),
                         "--sampler", "ode", "--ode-method", "etd2", "--N", "2"])
    except ValueError as e:
        check(str(e) == ETD_OUVP_REFUSAL, f"--ode-method etd2 under OUVP raised {e!r}")
        print(f"  --ode-method etd2 under OUVP refused: {e}", flush=True)
    else:
        fail("--ode-method etd2 under OUVP did not raise")
    return k1_paths, check_k1_at("the OUVP runs", shapes, gen)


def phase_new_modes_server(workdir: str, gen: torch.Generator):
    """Phase 43. The server with phase 41's checkpoints on phase 15's burst:
    --mode score-only at its bf16 default (N=SERVE_N + ald: X-NFE 2 N), then with
    --deepcache 3 (still 20: refreshes are not counted), and --mode
    denoiser-only (X-NFE 1); /healthz reports the mode; K1 launches per
    warm-up call and batch from the module list. Then denoiser-only
    streaming of phase 16's 12 s file (f32, the checkpoint's): 18 K1
    launches per call of 8 chunks. Returns ({path: K1}, K1's f32 and bf16
    errors)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    k1_paths, shapes = {}, set()
    for path, mode, extra, per_call, nfe in (
            ("server_score-only_bf16", "score-only", [], K1_PER_FORWARD * 2 * SERVE_N,
             2 * SERVE_N),
            ("server_score-only_dc3_bf16", "score-only", ["--deepcache", str(DC_K)],
             single_dc_launches("score-only", SERVE_N, 2), 2 * SERVE_N),
            ("server_denoiser-only_bf16", "denoiser-only", [], K1_PER_FORWARD, 1)):
        ckpt = os.path.join(workdir, f"{mode}.pt")
        r = run_server(path, serve_args(ckpt, "--mode", mode, *extra), waves, nfe=nfe)
        check(r["health"]["mode"] == mode, f"{path}: /healthz reports {r['health'].get('mode')}")
        calls = r["warmups"] + r["stats"]["batches"]
        want = per_call * calls
        print(f"  {path}: upfirdn2d launches {r['k1']}, expected {per_call} x ({r['warmups']} "
              f"warm-up + {r['stats']['batches']} batches) = {want}", flush=True)
        check(r["k1"] == want and r["k3"] == 0, f"{path}: launches {r['k1']}, {r['k3']}")
        check({s[-1] for s in r["k1_shapes"]} == {BF16}, f"{path} ran upfirdn2d in float32")
        k1_paths[path] = r["k1"]
        shapes |= r["k1_shapes"]

    noisy = os.path.join(workdir, "stream_noisy")
    out = os.path.join(workdir, "stream_denoiser")
    stream_lengths = {os.path.basename(f): load_wav(f)[0].shape[-1] for f in glob_wavs(noisy)}
    T = next(iter(stream_lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    calls = -(-len(range(0, T - overlap, chunk - overlap)) // STREAM_ROWS)
    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (k1s, _), calls_counted() as per_call:
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt",
                                os.path.join(workdir, "denoiser-only.pt"), "--mode",
                                "denoiser-only", "--stream_chunk_s", str(STREAM_CHUNK_S),
                                "--stream_overlap_s", str(STREAM_OVERLAP_S), "--timeit",
                                "--device", "cuda"])
    check_outputs(out, stream_lengths)
    want = [(K1_PER_FORWARD, 0, 1)] * calls
    print(f"  streaming denoiser-only: RTF {list(rtf_of(text).values())}; (K1, K3, NFE) per "
          f"call of {STREAM_ROWS} chunks {per_call}, expected {want[0]} x {calls}", flush=True)
    check(per_call == want, f"streaming denoiser-only: per call {per_call}")
    k1_paths["streaming_denoiser-only"] = kup.upfirdn2d_cuda.launches
    return (k1_paths, check_k1_at("the new modes' streaming run", k1s, gen),
            check_k1_at("the new modes' servers", shapes, gen))


def phase_new_modes_evaluate(workdir: str):
    """Phase 44. `python -m storm_tpu_torch.evaluate --mode score-only` and
    `--mode denoiser-only` on phase 39's test split (8 files, --batch 4 --N
    10 --csv), phase 41's checkpoints: exit with 8 rows, SI-SDR and ESTOI
    finite, exactly 18 K1 launches per forward (score-only: 20 per call,
    the denoiser 1), each row's SI-SDR within 1e-4 dB of BucketedEnhancer's
    output for the same file, grouping and seed (cuDNN deterministic).
    Returns {path: K1 launches}."""
    corpus = os.path.join(workdir, "train", "corpus")
    write_test_split(corpus)
    k1_paths = {}
    torch.backends.cudnn.deterministic = True
    try:
        for mode in SINGLE_MODES:
            ckpt = os.path.join(workdir, f"{mode}.pt")
            fw = {"score-only": 2 * ODE_N, "denoiser-only": 1}[mode]
            out_csv = os.path.join(workdir, f"evaluate_{mode}.csv")
            kup.upfirdn2d_cuda.launches = 0
            with calls_counted() as per_call:
                text = captured(evaluate.main, [
                    "--ckpt", ckpt, "--mode", mode, "--base_dir", corpus, "--num_files",
                    str(len(BATCH_SECONDS)), "--batch", str(EVAL_BATCH), "--N", str(ODE_N),
                    "--csv", out_csv, "--device", "cuda"])[1]
            k1_paths[f"evaluate_{mode}"] = kup.upfirdn2d_cuda.launches
            with open(out_csv) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == len(BATCH_SECONDS), f"evaluate {mode}: {len(rows)} CSV rows")
            check(all(np.isfinite(float(r["si_sdr"])) and np.isfinite(float(r["estoi"]))
                      for r in rows), f"evaluate {mode}: metrics not finite: {rows}")
            check("--- mean +/- 95% CI ---" in text, f"evaluate {mode}: no mean +/- CI lines")
            check(per_call == [(K1_PER_FORWARD * fw, 0, fw)] * 2
                  and k1_paths[f"evaluate_{mode}"] == 2 * K1_PER_FORWARD * fw,
                  f"evaluate {mode}: (K1, K3, NFE) per call {per_call}")
            served = served_si_sdr(served_model(ckpt), corpus, "pc")
            diffs = {r["file"]: abs(float(r["si_sdr"]) - served[r["file"]]) for r in rows}
            print(f"  evaluate --mode {mode}: {len(rows)} rows; (K1, K3, NFE) per call "
                  f"{per_call}; mean SI-SDR {np.mean([float(r['si_sdr']) for r in rows]):.3f} "
                  f"dB, ESTOI {np.mean([float(r['estoi']) for r in rows]):.4f}; |CSV SI-SDR - "
                  f"served| up to {max(diffs.values()):.2e} dB", flush=True)
            check(max(diffs.values()) <= EVAL_SI_SDR_ATOL_DB,
                  f"evaluate {mode}: SI-SDR parts from the enhancer's by {diffs}")
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return k1_paths


# --- phases 45-51: the one-step distilled student (`--mode distill`)

DISTILL_FORWARDS = 2  # per enhancement call: the denoiser and the student
# calibrate_distill: one denoiser forward and the student at 4 prior draws
DISTILL_CALIB_FORWARDS = 1 + 4
DISTILL_EVAL_FILES = 2
NF32 = 32  # the quality run's width (storm_tpu_torch/scripts/quality_run.sh)


def distill_model(teacher_ckpt: str, dtype: str):
    """A full-width student of the checkpoint's StoRM teacher on the card, as
    `train --mode distill` builds it: the teacher's config in `dtype`, params
    at its EMA weights, its score weights frozen as the teacher. Returns
    (the model, the teacher's EMA weights)."""
    c = load_training_checkpoint(teacher_ckpt)
    config = dict(c["config"], mode="distill", dtype=dtype, distill_N=DISTILL_N,
                  distill_method=DISTILL_METHOD)
    model = build_model(config, device="cuda", seed=0).train()
    model.load_state_dict(c["ema_params"], strict=True)
    model.with_teacher({k[len("score_net."):]: v for k, v in c["ema_params"].items()
                        if k.startswith("score_net.")})
    return model, c["ema_params"]


def phase_distill_step(teacher_ckpt: str, gen: torch.Generator):
    """Phase 45. One full-width f32 distill step (B=8, 256 x 256, etd2 targets
    of N=DISTILL_N) from phase 8's checkpoint, through the kernels and through the
    plain path (the same z, cuDNN deterministic): launches exactly as
    `step_launches` reads them from the module lists, each score-net gradient
    within GRAD_RTOL of its scale plus GRAD_FLOOR of the largest element and
    the global norm within GRAD_NORM_RTOL, the denoiser's gradients 0. Then one
    `train_step` timed between CUDA events with its peak memory: afterwards
    the denoiser is the teacher's bit for bit and the score net moved.
    Returns (the step's launches, its ms, its peak GiB, the gradients' norm
    error)."""
    model, teacher = distill_model(teacher_ckpt, "float32")
    want = step_launches("distill", DISTILL_TEACHER_FORWARDS)
    x = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    batch = (x, x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen))
    (z,) = model.draw_step(batch, gen)

    def grads():
        model.compute_gradients(batch, z)
        g = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        check(not any(bool(v.any()) for n, v in g.items() if n.startswith("denoiser_net.")),
              "the distill step gave the denoiser a gradient")
        return {n: v for n, v in g.items() if n.startswith("score_net.")}

    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        g_k = grads()
        torch.cuda.synchronize()
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            g_p = grads()
            torch.cuda.synchronize()
        check(counts == (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches),
              "the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    check(counts == want, f"one distill step launched {counts}, expected {want}")
    check(all(bool(torch.isfinite(v).all()) for v in g_k.values()), "gradients not finite")
    g_max = max(v.abs().max().item() for v in g_p.values())
    worst = max((g_k[n] - w).abs().max().item()
                / (GRAD_RTOL * w.abs().max().item() + GRAD_FLOOR * g_max) for n, w in g_p.items())
    d_norm = torch.sqrt(sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p)).item()
    norm = torch.sqrt(sum((v ** 2).sum() for v in g_p.values())).item()
    check(worst <= 1.0 and d_norm <= GRAD_NORM_RTOL * norm,
          f"the distill step's gradients part from plain: worst {worst:.3f}, norm {d_norm:.3e}")
    del g_k, g_p
    state = init_train_state(model, model.lr)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model.train_step(state, batch, gen)
    end.record()
    torch.cuda.synchronize()
    step_ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated() / 2**30
    sd = model.state_dict()
    check(all(torch.equal(sd[k].cpu(), v) for k, v in teacher.items()
              if k.startswith("denoiser_net.")), "Adam moved the student's denoiser")
    check(any(not torch.equal(sd[k].cpu(), v) for k, v in teacher.items()
              if k.startswith("score_net.")), "the student's score net did not move")
    print(f"  f32 distill step B={TRAIN_B} x {TRAIN_FRAMES} ({DISTILL_METHOD} N={DISTILL_N}: "
          f"{DISTILL_TEACHER_FORWARDS} teacher forwards): launches {counts}; gradients kernel vs "
          f"plain: worst tensor at {worst:.3f} of its tolerance, |diff| {d_norm / norm:.3e} of "
          f"the norm; after the step the denoiser is the teacher's bit for bit; step "
          f"{step_ms:.2f} ms, peak {peak:.2f} GiB", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return counts, step_ms, peak, d_norm / norm


def phase_distill_train(train_dir: str, teacher_ckpt: str, storm_bf16):
    """Phase 46. `python -m storm_tpu_torch.train --mode distill --teacher_ckpt`
    phase 25's bf16 checkpoint, one epoch of 4 steps at B=8 with
    `--num_eval_files 2`: phase_train's checks (K1 launches per step read from
    the module lists, all bf16; the evaluation's 2 forwards per call; the
    denoiser unmoved), the step and its peak memory beside StoRM's bf16 step
    (phase 25). Returns phase_train's dict."""
    r = phase_train(train_dir, "bfloat16", steps_total=TRAIN_FILES // TRAIN_B,
                    eval_files=DISTILL_EVAL_FILES, mode="distill",
                    extra=("--teacher_ckpt", teacher_ckpt, "--distill_N", str(DISTILL_N)),
                    tag="distill_")
    print(f"  distill bf16: {step_launches('distill', DISTILL_TEACHER_FORWARDS)} K1 launches "
          f"per step; step {r['step_ms']:.2f} ms, peak of the steps {r['step_peak_gib']:.2f} "
          f"GiB, against StoRM's {storm_bf16['step_ms']:.2f} ms and "
          f"{storm_bf16['step_peak_gib']:.2f} GiB (phase 25, bf16)", flush=True)
    return r


def phase_distill_cli(workdir: str, student_ckpt: str, lengths, exact, gen: torch.Generator):
    """Phase 47. `python -m storm_tpu_torch.enhancement --mode distill` with
    phase 46's checkpoint on phase 5's three files in f32, bf16 and --quant
    int8 --dtype bfloat16 twice (calibrates, then loads): per file exactly 36
    K1 launches and, int8, 110 K3 (55 per net); calibration's 5 forwards in
    the first int8 run's K1; the RTF beside StoRM's (phases 5 and 19); every
    K1 shape and K3 input against plain; `--deepcache 3` refused with the
    reference's message; the 4 s file's f32 output through the kernels
    against plain. Returns ({path: K1}, {path: K3}, K1's f32 and bf16
    errors, K3's error, {config: RTF of the 4 s file})."""
    ckpt = link_ckpt(workdir, student_ckpt, "distill.pt")
    noisy = os.path.join(workdir, "noisy")
    name = max(lengths, key=lengths.get)
    k1_paths, k3_paths, k1_shapes, k3_shapes, rtfs = {}, {}, set(), set(), {}
    for config, dtype, extra in (("float32", torch.float32, ["--dtype", "float32"]),
                                 ("bfloat16", BF16, ["--dtype", "bfloat16"]),
                                 ("int8_bfloat16", BF16, INT8_FLAGS),
                                 ("int8_bfloat16_cached", BF16, INT8_FLAGS)):
        out = os.path.join(workdir, f"enhanced_distill_{config}")
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "distill", "--timeit", "--device", "cuda", *extra])
        totals = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
        check_outputs(out, lengths)
        n_quant, calib = 0, 0
        if "int8" in config:
            cache = scale_cache_path(ckpt)
            n_quant = n_quantized(quant_mod.load_scales(cache))
            check(n_quant == 2 * N_QUANT, f"distill: {n_quant} quantized convs")
            if config == "int8_bfloat16":
                check(f"int8 calibration done ({n_quant} convs quantized" in text,
                      "distill: the first int8 run did not calibrate")
                calib = DISTILL_CALIB_FORWARDS
            else:
                check(f"int8 scales loaded from {cache} ({n_quant} convs" in text,
                      "distill: the second int8 run did not load the cache")
        want = (K1_PER_FORWARD * DISTILL_FORWARDS, n_quant, DISTILL_FORWARDS)
        check(per_call == [want] * len(lengths),
              f"distill {config}: (K1, K3, NFE) per file {per_call}, expected {want}")
        check(totals == (K1_PER_FORWARD * (DISTILL_FORWARDS * len(lengths) + calib),
                         n_quant * len(lengths)), f"distill {config}: launches {totals}")
        check({s[-1] for s in k1s} == {dtype}, f"distill {config} gave upfirdn2d {k1s}")
        path = f"enhancement_distill_{config}"
        k1_paths[path], k3_paths[path] = totals
        k1_shapes |= k1s
        k3_shapes |= k3s
        rtf, storm_rtf = rtf_of(text), exact[config.replace("_cached", "")][0]
        rtfs[config] = rtf[name]
        print(f"  distill {config}: (K1, K3, NFE) per file {per_call[0]} x {len(lengths)}, in all "
              f"{totals}" + (f" with {calib} calibration forwards" if calib else "")
              + "; RTF " + ", ".join(f"{n} {rtf[n]:.4f} (StoRM {storm_rtf[n]:.4f})"
                                     for n in lengths), flush=True)
    f32_err, bf16_err = (check_k1_at(f"the distill {what} CLI runs",
                                     {s for s in k1_shapes if s[-1] == dtype}, gen)
                         for what, dtype in (("float32", torch.float32), ("bf16", BF16)))
    k3_err = check_k3_at("the distill int8 bf16 runs", k3_shapes, gen)
    try:
        run_enhancement(["--test_dir", noisy, "--enhanced_dir", os.path.join(workdir, "dc"),
                         "--ckpt", ckpt, "--mode", "distill", "--deepcache", str(DC_K),
                         "--device", "cuda"])
    except ValueError as e:
        check(str(e) == DEEPCACHE_REFUSAL, f"--deepcache with distill raised {e!r}")
        print(f"  --mode distill --deepcache {DC_K} refused: {e}", flush=True)
    else:
        fail("--mode distill --deepcache did not raise")

    c = load_training_checkpoint(ckpt)
    model = build_model(dict(c["config"], dtype="float32"), device="cuda")
    model.load_state_dict(c["ema_params"], strict=True)
    y = bucketed(load_wav(os.path.join(noisy, name))[0])
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for plain in (False, True):
            ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
                   else contextlib.nullcontext())
            with ctx:
                gen0 = torch.Generator(device="cuda").manual_seed(0)
                runs.append(model.enhance(y, generator=gen0))
    finally:
        torch.backends.cudnn.deterministic = False
    (got, n), (want_x, _) = runs
    err, scale = (got - want_x).abs().max().item(), want_x.abs().max().item()
    print(f"  distill f32 NFE-2 output ({name}) through the kernels against plain: max abs err "
          f"{err:.3e} ({err / scale:.3e} of its scale)", flush=True)
    check(n == DISTILL_FORWARDS and err <= TRAJECTORY_RTOL * scale,
          f"distill: the kernels' output parts from plain by {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return k1_paths, k3_paths, max(f32_err, err), bf16_err, k3_err, rtfs


def phase_distill_serving(workdir: str, gen: torch.Generator):
    """Phase 48. Phase 47's checkpoint (bf16) through `--batch 4` on the 4 s
    file (one call, row-padded to 4) and streaming on phase 16's 12 s file
    (8 chunks a call): 36 K1 launches per call; then the server at its bf16
    default on phase 15's burst: X-NFE 2, /healthz's mode, 36 K1 launches per
    warm-up call and batch. Returns ({path: K1}, K1's error)."""
    ckpt = os.path.join(workdir, "distill.pt")
    k1_paths, shapes = {}, set()
    one = os.path.join(workdir, "distill_batch_in")
    os.makedirs(one)
    src = max(glob_wavs(os.path.join(workdir, "noisy")), key=lambda f: load_wav(f)[0].shape[-1])
    save_wav(os.path.join(one, os.path.basename(src)), load_wav(src)[0][0], SR)
    stream = os.path.join(workdir, "stream_noisy")
    T = load_wav(glob_wavs(stream)[0])[0].shape[-1]
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    stream_calls = -(-len(range(0, T - overlap, chunk - overlap)) // STREAM_ROWS)
    per_call = (K1_PER_FORWARD * DISTILL_FORWARDS, 0, DISTILL_FORWARDS)
    for path, src_dir, extra, calls in (
            ("batched_cli_distill_bf16", one, ["--batch", str(CLI_BATCH)], 1),
            ("streaming_distill_bf16", stream, ["--stream_chunk_s", str(STREAM_CHUNK_S),
                                                "--stream_overlap_s", str(STREAM_OVERLAP_S)],
             stream_calls)):
        out = os.path.join(workdir, path)
        kup.upfirdn2d_cuda.launches = 0
        with shapes_recorded() as (k1s, _), calls_counted() as counted:
            text = run_enhancement(["--test_dir", src_dir, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "distill", "--timeit", "--device", "cuda", *extra])
        check_outputs(out, {os.path.basename(f): load_wav(f)[0].shape[-1]
                            for f in glob_wavs(src_dir)})
        check(counted == [per_call] * calls, f"{path}: per call {counted}")
        check({s[-1] for s in k1s} == {BF16}, f"{path} gave upfirdn2d {k1s}")
        k1_paths[path] = kup.upfirdn2d_cuda.launches
        shapes |= k1s
        print(f"  {path}: (K1, K3, NFE) per call {per_call} x {calls}; rows "
              f"{sorted({s[1] for s in k1s})}; " + text.strip().splitlines()[-1].strip(),
              flush=True)
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    r = run_server("server_distill_bf16", serve_args(ckpt, "--mode", "distill"), waves,
                   nfe=DISTILL_FORWARDS)
    check(r["health"]["mode"] == "distill", f"/healthz reports {r['health'].get('mode')}")
    calls = r["warmups"] + r["stats"]["batches"]
    print(f"  server_distill_bf16: upfirdn2d launches {r['k1']}, expected {per_call[0]} x "
          f"({r['warmups']} warm-up + {r['stats']['batches']} batches) = {per_call[0] * calls}",
          flush=True)
    check(r["k1"] == per_call[0] * calls and r["k3"] == 0, f"distill server: {r['k1']}, {r['k3']}")
    check({s[-1] for s in r["k1_shapes"]} == {BF16}, "the distill server ran upfirdn2d in f32")
    k1_paths["server_distill_bf16"] = r["k1"]
    shapes |= r["k1_shapes"]
    return k1_paths, check_k1_at("the distill batched, streaming and server runs", shapes, gen)


def phase_distill_evaluate(workdir: str):
    """Phase 49. `python -m storm_tpu_torch.evaluate --mode distill` on phase
    39's test split (8 files, --batch 4 --csv), phase 47's checkpoint: 8
    rows, SI-SDR and ESTOI finite, 36 K1 launches per call, each row's SI-SDR
    within 1e-4 dB of BucketedEnhancer's output for the same file, grouping
    and seed (cuDNN deterministic). Returns {path: K1 launches}."""
    corpus = os.path.join(workdir, "train", "corpus")
    write_test_split(corpus)
    ckpt = os.path.join(workdir, "distill.pt")
    out_csv = os.path.join(workdir, "evaluate_distill.csv")
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = 0
        with calls_counted() as per_call:
            text = captured(evaluate.main, [
                "--ckpt", ckpt, "--mode", "distill", "--base_dir", corpus, "--num_files",
                str(len(BATCH_SECONDS)), "--batch", str(EVAL_BATCH), "--csv", out_csv,
                "--device", "cuda"])[1]
        launched = kup.upfirdn2d_cuda.launches
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == len(BATCH_SECONDS), f"evaluate distill: {len(rows)} CSV rows")
        check(all(np.isfinite(float(r["si_sdr"])) and np.isfinite(float(r["estoi"]))
                  for r in rows), f"evaluate distill: metrics not finite: {rows}")
        check("--- mean +/- 95% CI ---" in text, "evaluate distill: no mean +/- CI lines")
        want = (K1_PER_FORWARD * DISTILL_FORWARDS, 0, DISTILL_FORWARDS)
        check(per_call == [want] * 2 and launched == 2 * want[0],
              f"evaluate distill: (K1, K3, NFE) per call {per_call}")
        served = served_si_sdr(served_model(ckpt), corpus, "pc")
        diffs = {r["file"]: abs(float(r["si_sdr"]) - served[r["file"]]) for r in rows}
        print(f"  evaluate --mode distill: {len(rows)} rows; (K1, K3, NFE) per call {per_call}; "
              f"mean SI-SDR {np.mean([float(r['si_sdr']) for r in rows]):.3f} dB, ESTOI "
              f"{np.mean([float(r['estoi']) for r in rows]):.4f}; |CSV SI-SDR - served| up to "
              f"{max(diffs.values()):.2e} dB", flush=True)
        check(max(diffs.values()) <= EVAL_SI_SDR_ATOL_DB,
              f"evaluate distill: SI-SDR parts from the enhancer's by {diffs}")
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return {"evaluate_distill": launched}


def phase_distill_bench(gen: torch.Generator):
    """Phase 50. `python -m storm_tpu_torch.bench --distill` at bench.py's
    defaults otherwise (B=16, 256 frames, bf16, int8) with BENCH_REPS timed
    reps: its JSON line under the reference's metric; K1 launches 5
    calibration forwards + 36 per call, K3 110 per call; both kernels
    against plain at the shapes they gave. Returns (K1, K3, the line, K1's
    error, K3's error)."""
    from storm_tpu_torch import bench

    torch.cuda.empty_cache()
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    t0 = time.perf_counter()
    with shapes_recorded() as (k1s, k3s):
        _, text = captured(bench.main, ["--distill", "--reps", str(BENCH_REPS)])
    wall = time.perf_counter() - t0
    line = json.loads(text.strip().splitlines()[-1])
    calls = 1 + BENCH_REPS
    want = (K1_PER_FORWARD * (DISTILL_CALIB_FORWARDS + calls * DISTILL_FORWARDS),
            calls * 2 * N_QUANT)
    got = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
    print(f"  bench --distill: {wall:.1f} s wall; launches (K1, K3) {got}, expected {want}; "
          f"line {json.dumps(line)}", flush=True)
    check(line["metric"] == "audio_sec_per_sec_per_chip_distill_nfe2"
          and line["detail"]["nfe"] == DISTILL_FORWARDS and line["value"] > 0,
          f"bench --distill: {line}")
    check(got == want, f"bench --distill: launches {got}, expected {want}")
    check({s[-1] for s in k1s} == {BF16}, f"bench --distill gave upfirdn2d {k1s}")
    return (*got, line, check_k1_at("bench --distill", k1s, gen),
            check_k3_at("bench --distill", k3s, gen))


def phase_k1_nf32(gen: torch.Generator):
    """Phase 51. K1 at the quality run's width (nf=32, ch_mult (1,2,2,2)):
    one StoRM training step (B=8, 256 x 256) and one 4 s enhancement (B=1,
    256 x 576) of an nf=32 model in f32 and in bf16 record their upfirdn2d
    shapes; the forward kernel and its adjoint against plain at each, in
    its dtype. Returns (K1's f32, bf16 errors, the adjoint's f32, bf16
    errors)."""
    fwd, bwd = set(), set()
    y = bucketed(synth_wav(4.0, 0, np.random.default_rng(5))[None])
    for dtype in ("float32", "bfloat16"):
        model = build_model(dict(STORM_CONFIG, nf=NF32, dtype=dtype), device="cuda",
                            seed=0).train()
        x = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
        batch = (x, x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen))
        with shapes_recorded() as (k1s, _), adjoint_shapes_recorded() as bwds:
            model.compute_gradients(batch, *model.draw_step(batch, gen))
            model.eval()
            model.enhance(y, N=1, generator=torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
        fwd |= k1s
        bwd |= bwds
        del model
    channels = sorted({s[2] for s in fwd})
    check({NF32, 2 * NF32} <= set(channels) and not {NF, 2 * NF} & set(channels),
          f"the nf={NF32} runs gave upfirdn2d channels {channels}")
    check({s[1] for s in fwd} == {1, TRAIN_B} and {s[1] for s in bwd} == {TRAIN_B},
          f"the nf={NF32} runs gave batch rows {sorted({s[1] for s in fwd})}")
    print(f"  nf={NF32}: {len(fwd)} forward and {len(bwd)} adjoint shapes, channels {channels}",
          flush=True)
    errs = [check_k1_at(f"the nf={NF32} {what} runs", {s for s in fwd if s[-1] == dt}, gen)
            for what, dt in (("f32", torch.float32), ("bf16", BF16))]
    errs += [check_k1_bwd_at(f"the nf={NF32} {what} step", {s for s in bwd if s[-1] == dt}, gen)
             for what, dt in (("f32", torch.float32), ("bf16", BF16))]
    return errs


# --- each serving call as one captured CUDA graph (phases 52-55)

GRAPH_B4_SECONDS = 2.5  # phase 52's B=4 shape: four 2.5 s files, 40960 samples each
GRAPH_PICARD_SWEEPS = 4
GRAPH_N = 10  # phases 52-53's N for the ODE, Picard, score-only and profiled programs
GRAPH_REPLAYS = 5  # phase 53's counted replays
GRAPH_WARMUP = "1,2.5,4"  # phase 55's server ladder


def cuda_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def timed_call(fn):
    """(fn(), wall s); fn ends with the output's copy to the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def graph_against_eager(what: str, model, ys: np.ndarray, audio_s: float, rows, **kw):
    """One shape and configuration through `BucketedEnhancer`: the shape's
    first call (the eager loop itself: no capture; its time is the eager
    RTF), its second (the eager warm-up, then the capture) and a replay
    from the first call's generator state, which must equal the first call
    bit for bit. Appends to `rows` and returns (its row, the enhancer, the
    replay's output)."""
    progs = graphs.programs_of(model)
    graphed = BucketedEnhancer(model, **kw)
    before = dict(progs.stats)
    launched = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
    (want, nfe), eager_s = timed_call(lambda: graphed(ys, cuda_gen(1)))
    check(progs.stats["first_calls"] == before["first_calls"] + 1
          and progs.stats["captures"] == before["captures"],
          f"{what}: the shape's first call did more than the eager loop")
    _, second_s = timed_call(lambda: graphed(ys, cuda_gen(0)))
    check(progs.stats["captures"] == before["captures"] + 1, f"{what}: no capture")
    (got, gnfe), graph_s = timed_call(lambda: graphed(ys, cuda_gen(1)))
    err = float(np.abs(got - want).max())
    row = dict(what=what, nfe=nfe, audio_s=audio_s, eager_rtf=eager_s / audio_s,
               graph_rtf=graph_s / audio_s, second_s=second_s,
               capture_s=progs.stats["capture_s"] - before["capture_s"],
               pool_mib=(progs.stats["pool_bytes"] - before["pool_bytes"]) / 2 ** 20,
               static_mib=(progs.stats["static_bytes"] - before["static_bytes"]) / 2 ** 20,
               max_abs=err, f32=getattr(model, model.NETS[0]).dtype == torch.float32,
               k1=kup.upfirdn2d_cuda.launches - launched[0],
               k3=kq.quantize_int8_cuda.launches - launched[1])
    rows.append(row)
    print(f"  {what}: NFE {nfe}; RTF eager (the shape's first call) {row['eager_rtf']:.4f}, "
          f"replay {row['graph_rtf']:.4f} ({row['eager_rtf'] / row['graph_rtf']:.2f}x); second "
          f"call {second_s:.3f} s (capture {row['capture_s']:.3f} s, pool +{row['pool_mib']:.1f} "
          f"MiB, static buffers {row['static_mib']:.1f} MiB); max|replay - eager| {err:.3e}",
          flush=True)
    check(gnfe == nfe and err == 0.0, f"{what}: the replay parts from eager by {err:.3e}")
    return row, graphed, got


def graph_models(workdir: str):
    """The full-width models of phases 52-54 (seeded random weights; StoRM's
    are phase 5's checkpoint's) and phase 19's int8 scales."""
    ckpt = os.path.join(workdir, "storm.pt")
    bf16 = dict(STORM_CONFIG, dtype="bfloat16")
    storm_bf16 = build_model(bf16, device="cuda", seed=0)
    return dict(
        f32=build_model(STORM_CONFIG, device="cuda", seed=0), bf16=storm_bf16,
        score=build_model({"mode": "score-only", "init_scale": 1.0, "dtype": "bfloat16"},
                          device="cuda", seed=0),
        denoiser=build_model({"mode": "denoiser-only", "init_scale": 1.0, "dtype": "bfloat16"},
                             device="cuda", seed=0),
        distill=DistilledModel(storm_bf16), scales=quant_mod.load_scales(scale_cache_path(ckpt)))


def phase_graph_equals_eager(workdir: str, models, rows):
    """Phase 52. At the 4 s bucket (B=1, 576 frames) and, StoRM pc N=10 +
    ald bf16, at B=4 on the 2.5 s bucket: the shape's first call (the eager
    loop) and a replay from the same generator state, bit for bit (between
    them the second call captures), for StoRM pc N=10 + ald in f32, N=50 +
    ald in bf16, N=10 + ald in int8 + bf16, dc3 N=10 bf16, ode etd2 N=10 bf16, picard N=10 bf16, the
    score-only model's pc N=10 bf16, the denoiser-only model bf16 and the
    distilled NFE-2 path in bf16 and int8 + bf16. A second replay of the
    f32 program from another generator state equals eager from that state; weights swapped
    in place are served by the next replay, bit for bit eager's with them.
    Returns {config: the 4 s graph enhancer}."""
    y = load_wav(os.path.join(workdir, "noisy", f"utt2_{SECONDS[2]:.1f}s.wav"))[0][0]
    audio = y.shape[-1] / SR
    pc = dict(N=DEFAULT_N, corrector="ald")
    s = models["scales"]
    cases = [
        ("storm pc N=10 f32", models["f32"], dict(N=GRAPH_N, corrector="ald")),
        ("storm pc bf16", models["bf16"], pc),
        ("storm pc N=10 int8+bf16", models["bf16"],
         dict(N=GRAPH_N, corrector="ald", quant=s)),
        ("storm pc N=10 dc3 bf16", models["bf16"],
         dict(N=GRAPH_N, corrector="ald", deepcache=DC_K)),
        ("storm ode etd2 N=10 bf16", models["bf16"],
         dict(N=GRAPH_N, sampler_type="ode", method=ODE_METHOD)),
        ("storm picard N=10 bf16", models["bf16"],
         dict(N=GRAPH_N, sampler_type="picard", sweeps=GRAPH_PICARD_SWEEPS)),
        ("score-only pc N=10 bf16", models["score"], dict(N=GRAPH_N, corrector="ald")),
        ("denoiser-only bf16", models["denoiser"], {}),
        ("distill bf16", models["distill"], {}),
        ("distill int8+bf16", models["distill"], dict(quant=s)),
    ]
    enhancers = {}
    for what, model, kw in cases:
        _, enhancers[what], _ = graph_against_eager(f"{what}, 4 s", model, y, audio, rows, **kw)

    # another generator state, on the same program
    short = dict(N=GRAPH_N, corrector="ald")
    enh = enhancers["storm pc N=10 f32"]
    got, want = enh(y, cuda_gen(2))[0], BucketedEnhancer(models["f32"], graphs=False,
                                                          **short)(y, cuda_gen(2))[0]
    err = float(np.abs(got - want).max())
    print(f"  storm pc N=10 f32, 4 s, another generator state: max|replay - eager| {err:.3e}",
          flush=True)
    check(err == 0.0, f"a replay from another state parts from eager by {err:.3e}")

    # weights swapped in place (the trainer's evaluation does this with the EMA)
    dist = enhancers["distill bf16"]
    before, _ = dist(y, cuda_gen(3))
    other = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=1).state_dict()
    with swapped_in(models["distill"], other):
        got, _ = dist(y, cuda_gen(3))
        want, _ = BucketedEnhancer(models["distill"], graphs=False)(y, cuda_gen(3))
    err = float(np.abs(got - want).max())
    moved = float(np.abs(got - before).max())
    print(f"  distill bf16 with other weights swapped in: max|replay - eager| {err:.3e}; "
          f"max|new - old weights' output| {moved:.3e}", flush=True)
    check(err == 0.0 and moved > 0.0, "the replay did not serve the swapped-in weights")

    rng = np.random.default_rng(5)
    ys = np.stack([synth_wav(GRAPH_B4_SECONDS, i, rng) for i in range(CLI_BATCH)])
    graph_against_eager(f"storm pc N=10 bf16, B={CLI_BATCH} x {GRAPH_B4_SECONDS} s",
                        models["bf16"], ys, CLI_BATCH * GRAPH_B4_SECONDS, rows,
                        N=GRAPH_N, corrector="ald")
    return enhancers


def phase_graph_launches(workdir: str, models, enhancers):
    """Phase 53. One replay under torch.profiler each of a StoRM pc + ald
    program at N=10 (4 s; fewer events to read than at N=50) in bf16, int8
    + bf16 and dc3 bf16, captured here: its K1 and K3
    kernel events by name equal the derived counts (18 K1 per forward, 55
    K3 per quantized forward, dc3's from the module list), and its busy
    share; then GRAPH_REPLAYS replays of the distilled int8 program add
    exactly that many times its recorded launches to the counters. Returns
    {config: busy share of its replay}."""
    from torch.profiler import ProfilerActivity, profile

    y = load_wav(os.path.join(workdir, "noisy", f"utt2_{SECONDS[2]:.1f}s.wav"))[0][0]
    short = dict(N=GRAPH_N, corrector="ald")
    nfe = 1 + 2 * GRAPH_N
    cases = [("storm pc N=10 bf16", BucketedEnhancer(models["bf16"], **short),
              K1_PER_FORWARD * nfe, 0),
             ("storm pc N=10 int8+bf16",
              BucketedEnhancer(models["bf16"], quant=models["scales"], **short),
              K1_PER_FORWARD * nfe, N_QUANT * nfe),
             ("storm pc N=10 dc3 bf16", BucketedEnhancer(models["bf16"], deepcache=DC_K, **short),
              dc_call_launches(GRAPH_N, 2)[0], 0)]
    busy = {}
    for what, enh, want_k1, want_k3 in cases:
        enh.warm_up(y, cuda_gen(5))  # makes the program
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enh(y, cuda_gen(4))
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = kernel_events(prof)
        k1 = sum(1 for e in events if "upfirdn2d_down" in e[2] or "upfirdn2d_up" in e[2])
        k3 = sum(1 for e in events if "quantize_int8_kernel" in e[2])
        busy_ms, end = 0.0, -float("inf")
        for start, stop, _, _ in events:
            busy_ms += max(0.0, stop - max(start, end)) / 1e3
            end = max(end, stop)
        busy[what] = busy_ms / wall_ms
        print(f"  {what}: one replay under the profiler: wall {wall_ms:.1f} ms, {len(events)} "
              f"kernel events, busy {busy_ms:.1f} ms ({100 * busy[what]:.1f}% of wall); K1 "
              f"events {k1} (derived {want_k1}), K3 {k3} (derived {want_k3})", flush=True)
        check((k1, k3) == (want_k1, want_k3), f"{what}: a replay ran K1 {k1}, K3 {k3} times")

    dist = BucketedEnhancer(models["distill"], quant=models["scales"])
    prog = next(p for p in graphs.programs_of(models["distill"]).programs.values()
                if dict(p.key[-1]).get("quant"))
    before = [f.launches for f in LAUNCH_COUNTERS_ALL]
    for i in range(GRAPH_REPLAYS):
        dist(y, cuda_gen(10 + i))
    added = tuple(f.launches - b for f, b in zip(LAUNCH_COUNTERS_ALL, before))
    want = tuple(GRAPH_REPLAYS * n for n in prog.launches)
    print(f"  distill int8+bf16: {GRAPH_REPLAYS} replays added {added} to the counters (K1, "
          f"K1-bwd, K3, K2); recorded per replay {prog.launches}", flush=True)
    check(added == want and prog.launches[0] == K1_PER_FORWARD * DISTILL_FORWARDS
          and prog.launches[2] == 2 * N_QUANT, f"distill replays added {added}, expected {want}")
    return busy


def phase_graph_time(workdir: str, models, rows, busy):
    """Phase 54. RTF graph against eager at B=1 on phase 5's 1 and 2.5 s
    files (the 4 s rows are phase 52's, StoRM pc at N=50) for StoRM pc N=10
    + ald in bf16, dc3 N=10 bf16 and the distilled NFE-2 path in bf16 (int8
    + bf16 at 4 s only: phase 52's N=10 row), each replay
    equal to eager bit for bit; then every row of phases 52 and 54: RTF both
    ways, the capture's seconds and the pool's growth, the busy share of
    phase 53's replays."""
    short = dict(N=GRAPH_N, corrector="ald")
    for seconds in SECONDS[:2]:
        y = load_wav(os.path.join(workdir, "noisy", f"utt{SECONDS.index(seconds)}_"
                                                    f"{seconds:.1f}s.wav"))[0][0]
        audio = y.shape[-1] / SR
        for what, model, kw in (
                ("storm pc N=10 bf16", models["bf16"], short),
                ("storm pc N=10 dc3 bf16", models["bf16"], dict(short, deepcache=DC_K)),
                ("distill bf16", models["distill"], {})):
            graph_against_eager(f"{what}, {seconds:g} s", model, y, audio, rows, **kw)
    print("  | configuration | NFE | RTF eager (first call) | RTF replay | eager / replay | "
          "second call s | capture s | pool MiB | static MiB |", flush=True)
    for r in rows:
        print(f"  | {r['what']} | {r['nfe']} | {r['eager_rtf']:.4f} | {r['graph_rtf']:.4f} | "
              f"{r['eager_rtf'] / r['graph_rtf']:.2f} | {r['second_s']:.3f} | "
              f"{r['capture_s']:.3f} | {r['pool_mib']:.1f} | {r['static_mib']:.1f} |", flush=True)
    for what, share in busy.items():
        print(f"  busy share of one {what} replay (4 s, phase 53): {100 * share:.1f}%",
              flush=True)
    for what, model in (("StoRM f32", models["f32"]), ("StoRM bf16", models["bf16"]),
                        ("distill", models["distill"])):
        st = graphs.programs_of(model).stats
        print(f"  {what}'s programs: {st['captures']} captures in {st['capture_s']:.2f} s, "
              f"{st['replays']} replays, one pool of {st['pool_bytes'] / 2 ** 30:.2f} GiB and "
              f"static buffers of {st['static_bytes'] / 2 ** 30:.2f} GiB: "
              f"{(st['pool_bytes'] + st['static_bytes']) / 2 ** 30:.2f} GiB held", flush=True)


def phase_graph_serving(workdir: str, bench_line, gen: torch.Generator):
    """Phase 55. The server at its bf16 default (N=SERVE_N) with
    --warmup_buckets 1,2.5,4: the warm-up captures 3 row sizes x 3 buckets,
    phase 21's burst then captures nothing and replays every batch; its
    audio s/s, p50 and max against the same server with graphs=False. The
    streaming CLI (bf16) on two copies of phase 16's 12 s file: the first
    call captures, the second replays. Phase 32's bench line with graphs.
    Returns ({path: K1 launches}, K1 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    args = serve_args(ckpt, "--warmup_buckets", GRAPH_WARMUP)
    runs, k1_paths, shapes = {}, {}, set()
    for path, ctx in (("server_bf16_eager", mock.patch.object(
            serve, "BucketedEnhancer", functools.partial(BucketedEnhancer, graphs=False))),
                      ("server_bf16_graphs", contextlib.nullcontext())):
        with ctx:
            r = run_server(path, args, waves)
        want = K1_PER_FORWARD * SERVE_NFE * (r["warmups"] + r["stats"]["batches"])
        check(r["k1"] == want, f"{path}: K1 {r['k1']}, expected {want}")
        runs[path], k1_paths[path] = r, r["k1"]
        shapes |= r["k1_shapes"]
    g = runs["server_bf16_graphs"]
    st, rows, buckets = g["stats"]["graphs"], len(g["health"]["row_sizes"]), len(
        g["health"]["warmup_buckets_s"])
    print(f"  graphs: /healthz execution {g['health']['execution']!r}; /stats graphs {st}; "
          f"burst audio s/s {g['audio_per_s']:.4f} against eager "
          f"{runs['server_bf16_eager']['audio_per_s']:.4f}, p50 {g['p50']:.3f} s against "
          f"{runs['server_bf16_eager']['p50']:.3f}, max {g['max']:.3f} s against "
          f"{runs['server_bf16_eager']['max']:.3f}; the warmed ladder's pool "
          f"{st['pool_bytes'] / 2 ** 30:.2f} GiB and static buffers "
          f"{st['static_bytes'] / 2 ** 30:.2f} GiB in {st['capture_s']:.2f} s of captures",
          flush=True)
    check(g["health"]["execution"] == "graph"
          and runs["server_bf16_eager"]["health"]["execution"] == "eager",
          "/healthz execution")
    check(st["captures"] == rows * buckets == 9 and st["replays"] == g["stats"]["batches"]
          and st["first_calls"] == 0, f"the burst captured after warm-up or did not replay: {st}")

    src = os.path.join(workdir, "stream_noisy")
    thrice = os.path.join(workdir, "stream_thrice")
    os.makedirs(thrice)
    name = sorted(os.listdir(src))[0]
    for copy in ("a_" + name, "b_" + name, "c_" + name):
        os.link(os.path.join(src, name), os.path.join(thrice, copy))
    replays = []
    real_replay = graphs.Program.replay

    def replay(prog):
        replays.append(prog.launches)
        return real_replay(prog)

    kup.upfirdn2d_cuda.launches = 0
    with calls_counted() as per_call, mock.patch.object(graphs.Program, "replay", replay), \
            shapes_recorded() as (k1s, _):
        text = run_enhancement(["--test_dir", thrice, "--enhanced_dir",
                                os.path.join(workdir, "stream_thrice_out"), "--ckpt", ckpt,
                                "--mode", "storm", "--N", str(SERVE_N), "--stream_chunk_s",
                                str(STREAM_CHUNK_S), "--stream_overlap_s", str(STREAM_OVERLAP_S),
                                "--timeit", "--device", "cuda", "--dtype", "bfloat16"])
    want = (K1_PER_FORWARD * SERVE_NFE, 0, SERVE_NFE)
    print(f"  streaming bf16, the 12 s file thrice: RTF {list(rtf_of(text).values())} (the "
          f"eager loop, the capture, the replay); (K1, K3, NFE) per call {per_call}, {len(replays)} "
          f"replay(s)", flush=True)
    check(per_call == [want] * 3 and len(replays) == 1, f"streaming thrice: {per_call}, {replays}")
    k1_paths["streaming_bf16_thrice"] = kup.upfirdn2d_cuda.launches
    shapes |= k1s
    print(f"  bench (phase 32, graphs): {bench_line['value']} audio s/s, a replay "
          f"{bench_line['detail']['wall_s']} s per call", flush=True)
    return k1_paths, check_k1_at("the graph servers and streaming", shapes, gen)


# --- the trainer's programs as captured graphs (phases 56-58)

TRAIN_GRAPH_STEPS = 3  # phase 56's steps per mode: eager, warm-up and capture, a replay
# phase 56's replays under the profiler: two of the bf16 StoRM step (phase
# 28's bf16 profile traces two eager steps), one of the others
TRAIN_GRAPH_PROFILED = {"storm joint bf16": 2}
SAVE_REPS = 2  # phase 58's saves per manager


def train_waves(seed: int):
    """(clean, noisy) wav batch at the trainer's defaults: B=8 crops of 256
    frames (32640 samples), float32."""
    rng = np.random.default_rng(seed)
    n = (TRAIN_FRAMES - 1) * HOP
    x = np.stack([synth_wav(n / SR, i + seed, rng) for i in range(TRAIN_B)])
    return x, (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


def train_state_tensors(state):
    """Everything a step changes, by name: parameters, EMA, Adam's state, the
    device step count."""
    out = {f"param {k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema {k}": v for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam {i} {k}": v for k, v in st.items()})
    out["device_step"] = state.device_step
    return out


def max_abs_diff(got, want) -> float:
    """max |got - want| over dicts of tensors with the same keys (NaN if
    either holds one), read with one sync."""
    check(got.keys() == want.keys(), f"keys differ: {set(got) ^ set(want)}")
    return float(torch.stack([(got[k].float() - want[k].float()).abs().max()
                              for k in want]).max())


def timed_event(fn):
    """(fn(), ms) between two CUDA events after a sync: the host's enqueue
    and the device's work, whichever is longer."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_train_graphs(teacher_ckpt: str, trainers):
    """Phase 56. Each mode's training step as a captured graph against the
    eager step at full width, B=8 x 256 frames, cuDNN deterministic: StoRM
    joint in f32 and bf16, score-only bf16, denoiser-only sisdr f32 and the
    distilled student in bf16 (phase 45's f32 checkpoint as the teacher,
    etd2 N=4). From one initial model, TRAIN_GRAPH_STEPS eager steps
    (`TrainPrograms(graphs=False)`) and as many through the programs (the
    eager first call, the warm-up and capture, then replays), on the same
    wav batches and generator states: after every step the losses,
    parameters, EMA, Adam's moments and step counts and the device step
    count must be equal (max abs 0). Each step is timed between CUDA events
    (after a sync): the eager steps after the first against the replays;
    the peak allocated and reserved memory of each run (with the program's
    pool) and the capture's seconds. Then TRAIN_GRAPH_PROFILED replays
    (one, two of the bf16 StoRM step) under torch.profiler: the counters grew by exactly `step_launches` per
    replay, K1's kernel events (forward and adjoint share the kernels' names)
    equal them, and the replay's busy share of its wall. Beside them, the
    trainer's replayed periods of phases 8 and 25 (`trainers`)."""
    from torch.profiler import ProfilerActivity, profile

    cases = [("storm joint f32", "regen-joint-training", dict(STORM_CONFIG)),
             ("storm joint bf16", "regen-joint-training", dict(STORM_CONFIG, dtype="bfloat16")),
             ("score-only bf16", "score-only",
              {"mode": "score-only", "init_scale": 1.0, "dtype": "bfloat16"}),
             ("denoiser-only sisdr f32", "denoiser-only",
              {"mode": "denoiser-only", "init_scale": 1.0, "loss_type": "sisdr"}),
             ("distill bf16", "distill", None)]
    batches = [train_waves(i) for i in range(TRAIN_GRAPH_STEPS)]
    rows = []
    print(f"  at the start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    for what, mode, cfg in cases:
        def make():
            model = (distill_model(teacher_ckpt, "bfloat16")[0] if cfg is None
                     else build_model(cfg, device="cuda", seed=0).train())
            state = init_train_state(model, model.lr)
            return state

        runs, launched = {}, (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        torch.backends.cudnn.deterministic = True
        try:
            for graphed in (False, True):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                state = make()
                programs = train_graphs.TrainPrograms(state, graphs=graphed)
                if not graphed:  # before any step: copies made later would hold its blocks
                    saved = [{k: torch.empty_like(v) for k, v in train_state_tensors(state).items()}
                             for _ in batches]
                out, ms = [], []
                for i, batch in enumerate(batches):
                    aux, t = timed_event(lambda: programs.step(batch, cuda_gen(100 + i)))
                    ms.append(t)
                    if graphed:
                        got = dict(train_state_tensors(state), **{f"aux {k}": v
                                                                  for k, v in aux.items()})
                        out.append(max_abs_diff(got, saved[i]))
                    else:
                        for k, v in train_state_tensors(state).items():
                            saved[i][k].copy_(v)
                        saved[i].update({f"aux {k}": v.clone() for k, v in aux.items()})
                runs[graphed] = dict(out=out, ms=ms, peak=torch.cuda.max_memory_allocated() / 2**30,
                                     reserved=torch.cuda.max_memory_reserved() / 2**30)
                if not graphed:
                    del state, programs
            errs = runs[True]["out"]
            st = programs.stats
            check(st["captures"] == 1 and st["replays"] == TRAIN_GRAPH_STEPS - 2,
                  f"{what}: the program's counters {st}")

            # the same program (its key holds cuDNN's flags)
            fwd, bwd = step_launches(mode, DISTILL_TEACHER_FORWARDS)
            n = TRAIN_GRAPH_PROFILED.get(what, 1)
            before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(n):
                    programs.step(batches[i], cuda_gen(200 + i))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            check(programs.stats["replays"] == TRAIN_GRAPH_STEPS - 2 + n,
                  f"{what}: the profiled steps did not replay: {programs.stats}")
        finally:
            torch.backends.cudnn.deterministic = False
        added = (kup.upfirdn2d_cuda.launches - before[0], kup.upfirdn2d_bwd_cuda.launches - before[1])
        events = kernel_events(prof)
        k1 = sum(1 for e in events if "upfirdn2d_down" in e[2] or "upfirdn2d_up" in e[2])
        busy_ms, end = 0.0, -float("inf")
        for start, stop, _, _ in events:
            busy_ms += max(0.0, stop - max(start, end)) / 1e3
            end = max(end, stop)
        counted = n * (fwd + bwd)
        row = dict(what=what, err=max(errs), eager_ms=statistics.median(runs[False]["ms"][1:]),
                   replay_ms=statistics.median(runs[True]["ms"][2:]),
                   second_s=runs[True]["ms"][1] / 1e3, capture_s=st["capture_s"],
                   pool_gib=st["pool_bytes"] / 2**30, eager_peak=runs[False]["peak"],
                   eager_reserved=runs[False]["reserved"], peak=runs[True]["peak"],
                   reserved=runs[True]["reserved"], busy=busy_ms / wall_ms, k1=k1,
                   launches=(fwd, bwd), bf16="bf16" in what,
                   k1_launched=(kup.upfirdn2d_cuda.launches - launched[0],
                                kup.upfirdn2d_bwd_cuda.launches - launched[1]))
        rows.append(row)
        print(f"  {what}: max|replay - eager| per step {errs} (losses, parameters, EMA, Adam, "
              f"step counts); step ms eager {[round(t, 2) for t in runs[False]['ms']]}, through "
              f"the program {[round(t, 2) for t in runs[True]['ms']]} (the eager first call, the "
              f"warm-up and capture, replays); capture {st['capture_s']:.3f} s, pool "
              f"{row['pool_gib']:.2f} GiB (reserved before the warm-up "
              f"{st['reserved_before_warm_up'] / 2**30:.2f} GiB, before the capture "
              f"{st['reserved_before_capture'] / 2**30:.2f} GiB); peak allocated / reserved eager "
              f"{row['eager_peak']:.2f} / {row['eager_reserved']:.2f} GiB, with the program "
              f"{row['peak']:.2f} / {row['reserved']:.2f} GiB", flush=True)
        print(f"  {what}: {n} replays under the profiler: wall {wall_ms:.1f} ms, {len(events)} "
              f"kernel events, busy {busy_ms:.1f} ms ({100 * row['busy']:.1f}% of wall); K1 "
              f"events {k1} of {counted} counted, counters added {added}, derived {n} x "
              f"{(fwd, bwd)}", flush=True)
        check(all(e == 0.0 for e in errs), f"{what}: a replayed step parts from eager: {errs}")
        # the profile rule (PROFILE_MIN_MATCHED): the profiler may drop a few
        # of a long trace's events (the distill step's 40k), never add one
        check(added == (n * fwd, n * bwd) and PROFILE_MIN_MATCHED * counted <= k1 <= counted,
              f"{what}: {n} replays launched {added} ({k1} K1 events), expected {n} x "
              f"{(fwd, bwd)}")
        del state, programs, runs, saved
        torch.cuda.empty_cache()
    print("  | mode | eager step ms | replayed step ms | eager / replay | busy (replays) | "
          "capture s | pool GiB | peak alloc / reserved GiB, eager | with the program |",
          flush=True)
    for r in rows:
        print(f"  | {r['what']} | {r['eager_ms']:.2f} | {r['replay_ms']:.2f} | "
              f"{r['eager_ms'] / r['replay_ms']:.2f} | {100 * r['busy']:.1f}% | "
              f"{r['capture_s']:.3f} | {r['pool_gib']:.2f} | {r['eager_peak']:.2f} / "
              f"{r['eager_reserved']:.2f} | {r['peak']:.2f} / {r['reserved']:.2f} |", flush=True)
    for what, t in trainers.items():
        print(f"  the trainer's {what} (phase {t['phase']}): replayed step period "
              f"{t['step_ms']:.2f} ms median, peak {t['peak_gib']:.2f} GiB allocated, "
              f"{t['reserved_gib']:.2f} GiB reserved, capture {t['capture_s']:.3f} s, pool "
              f"{t['pool_gib']:.2f} GiB", flush=True)
    return rows


def phase_train_resume(train_dir: str):
    """Phase 57. `python -m storm_tpu_torch.train --dtype bfloat16` through its
    programs on phase 8's corpus, cuDNN deterministic, no evaluation: two
    epochs in one run (its epoch-0 `last.pt` kept), and a run resumed from
    that file for the second epoch (its own eager first step and capture):
    the two runs' final `last.pt` equal bit for bit (parameters, EMA, Adam's
    moments and step counts, meta)."""
    corpus = os.path.join(train_dir, "corpus")
    epoch_len = TRAIN_FILES // TRAIN_B
    argv = ["--mode", "regen-joint-training", "--base_dir", corpus, "--format", "wsj0",
            "--batch_size", str(TRAIN_B), "--num_frames", str(TRAIN_FRAMES), "--max_epochs", "2",
            "--num_eval_files", "0", "--log_every_n_steps", str(epoch_len), "--num_workers", "4",
            "--seed", "0", "--dtype", "bfloat16", "--device", "cuda"]
    whole, split = os.path.join(train_dir, "resume_whole"), os.path.join(train_dir, "resume_split")
    kept = os.path.join(train_dir, "resume_epoch0.pt")
    real_write = CheckpointManager.write

    def keep_epoch0(mgr, payload, **kw):
        real_write(mgr, payload, **kw)
        if kw["epoch"] == 0:
            shutil.copyfile(mgr.path("last"), kept)

    torch.backends.cudnn.deterministic = True
    try:
        with mock.patch.object(CheckpointManager, "write", keep_epoch0):
            captured(train.main, argv + ["--log_dir", whole])
        _, text = captured(train.main, argv + ["--log_dir", split, "--resume_from_checkpoint",
                                               kept])
    finally:
        torch.backends.cudnn.deterministic = False
    check(f"at step {epoch_len}, epoch 1" in text, "the run did not resume at epoch 1")
    ends = [load_training_checkpoint(os.path.join(d, os.listdir(d)[0], "checkpoints", "last.pt"))
            for d in (whole, split)]
    got, want = ends[1], ends[0]
    check(got["step"] == want["step"] == 2 * epoch_len and got["meta"] == want["meta"],
          f"resumed run at step {got['step']}, meta {got['meta']}; continuous {want['step']}")
    errs = [max_abs_diff(got[k], want[k]) for k in ("params", "ema_params")]
    errs += [max_abs_diff(got["optimizer"]["state"][i], s)
             for i, s in want["optimizer"]["state"].items()]
    print(f"  bf16, {2 * epoch_len} steps: two epochs in one run against one epoch and a resume "
          f"from its last.pt: max abs difference of the parameters {errs[0]:.3e}, the EMA "
          f"{errs[1]:.3e}, Adam's state {max(errs[2:]):.3e}", flush=True)
    check(max(errs) == 0.0, f"the resumed run parts from the continuous one: {max(errs)}")


def phase_async_save(workdir: str):
    """Phase 58. A full-width f32 StoRM train state (one update on zero
    gradients makes Adam's moments) saved SAVE_REPS times in turns by
    `CheckpointManager.step` and by `AsyncCheckpointManager.step`: the wall
    the training loop waits per epoch (the synchronous save's whole wall;
    the async manager's `step`: the device snapshot's enqueue, with no save
    in flight) against the async save's wall to its end (`wait`); the two
    managers' `last.pt` equal bit for bit."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0).train()
    state = init_train_state(model, model.lr)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.zeros_like(p)
    model.apply_update(state)
    kw = dict(valid_loss=1.0, epoch=0, bad_epochs=0, best_valid=1.0, pesq=math.nan, estoi=0.5)
    sync = CheckpointManager(os.path.join(workdir, "save_sync"), STORM_CONFIG)
    asyn = AsyncCheckpointManager(CheckpointManager(os.path.join(workdir, "save_async"),
                                                    STORM_CONFIG))
    walls = {"sync": [], "async_step": [], "async_wait": []}
    for _ in range(SAVE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.step(state, **kw)
        walls["sync"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyn.step(state, **kw)
        walls["async_step"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        asyn.wait()
        walls["async_wait"].append(time.perf_counter() - t0)
    got, want = (load_training_checkpoint(m.path("last")) for m in (asyn, sync))
    errs = [max_abs_diff(got[k], want[k]) for k in ("params", "ema_params")]
    errs += [max_abs_diff(got["optimizer"]["state"][i], st)
             for i, st in want["optimizer"]["state"].items()]
    size = os.path.getsize(sync.path("last")) / 2**20
    print(f"  f32 StoRM state, last.pt of {size:.1f} MiB: the loop waits "
          f"{[round(w, 4) for w in walls['async_step']]} s for the async save against "
          f"{[round(w, 3) for w in walls['sync']]} s for the synchronous one; the async save "
          f"ends {[round(w, 3) for w in walls['async_wait']]} s later, in its thread; the "
          f"files' max abs difference {max(errs):.3e}", flush=True)
    check(max(errs) == 0.0 and got["step"] == want["step"] and got["meta"] == want["meta"],
          "the async save wrote another checkpoint than the synchronous one")
    del model, state
    torch.cuda.empty_cache()
    return walls



# --- the NCSN++ family's other configurations and the time-domain denoisers
# (phases 59-64)

# a full-width NCSN++ with DDPM resblocks and residual pyramids: every
# resampler convolves, so every upfirdn2d call is the stride-1 instance
DDPM_KW = dict(resblock_type="ddpm", progressive="residual", progressive_input="residual",
               init_scale=1.0)
DDPM_DENOISER = {"mode": "denoiser-only", **DDPM_KW}
S1_PER_FORWARD = 12  # 3 down levels x (trunk + input pyramid) + 3 up x (trunk + output pyramid)
LARGE_STORM = {**STORM_CONFIG, "backbone_score": "ncsnpplarge"}
LARGE_PER_FORWARD = 36  # 6 levels x (a resampling resblock's 2 + a pyramid's 1), each way
TIME_DOMAIN = ("convtasnet", "ae-ncsnpp")


@contextlib.contextmanager
def k1_calls_recorded():
    """While active, every upfirdn2d call of the nets (nn/resample.py) adds its
    (config, B, C, H, W, dtype) to the first yielded list, in order, and
    every backward of `UpFirDn2d` its forward's to the second; the calls run
    as before."""
    fwd, bwd = [], []
    real = kup.UpFirDn2d.backward

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
        fwd.append((config_of(up, down, pad), *x.shape, x.dtype))
        return kup.upfirdn2d(x, kernel, up=up, down=down, pad=pad)

    def backward(ctx, g):
        _, up, down, pad, (H, W) = ctx.args
        bwd.append((config_of(up, down, pad), g.shape[0], g.shape[1], H, W, g.dtype))
        return real(ctx, g)

    with mock.patch.object(resample, "upfirdn2d", upfirdn2d), \
            mock.patch.object(kup.UpFirDn2d, "backward", staticmethod(backward)):
        yield fwd, bwd


def ddpm_net(dtype=torch.float32) -> NCSNpp:
    net = NCSNpp(input_channels=6, dtype=dtype, **DDPM_KW)
    reset_parameters(net, torch.Generator().manual_seed(0))
    return net.cuda()


def phase_ddpm(workdir: str, lengths, gen: torch.Generator):
    """Phase 59. A full-width DDPM + residual NCSN++ score net (nf 128, ch_mult
    1,2,2,2; every resampler a FIR with a 3x3 conv: the stride-1 instance),
    in f32 and bf16, cuDNN deterministic: one forward at the 4 s bucket (B=1,
    256 x 576) and one gradient of a B=8 x 256 x 256 batch (input and
    parameters) through the kernels against the plain path, with exactly the
    module list's launches (12 per forward, 12 adjoints per backward); then
    a DDPM denoiser-only checkpoint through `python -m
    storm_tpu_torch.enhancement` on phase 5's files in f32 and bf16 (12
    launches per file). Returns ({dtype: [forward calls]}, {dtype: [adjoint
    calls]}, {(dtype, direction): {path: launches}})."""
    fwd_calls, bwd_calls, launched = {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for dtype in (torch.float32, BF16):
            name = str(dtype).split(".")[-1]
            net = ddpm_net(dtype)
            check(k1_per_forward(net) == S1_PER_FORWARD,
                  f"the DDPM net's module list gives {k1_per_forward(net)} calls")
            x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
            t = torch.full((1,), 0.5, device="cuda")
            xb = 0.5 * torch.randn(TRAIN_B, 3, FREQS, TRAIN_FRAMES, 2, device="cuda",
                                   generator=gen)
            tb = torch.rand(TRAIN_B, device="cuda", generator=gen) * 0.9 + 0.05
            runs = []
            for plain in (False, True):
                ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
                       else k1_calls_recorded())
                before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
                with ctx as rec:
                    with torch.inference_mode():
                        out = net(x, t)
                    xg = xb.clone().requires_grad_()
                    params = [p for p in net.parameters() if p.requires_grad]
                    grads = torch.autograd.grad(net(xg, tb).square().sum(), [xg] + params)
                    torch.cuda.synchronize()
                counts = (kup.upfirdn2d_cuda.launches - before[0],
                          kup.upfirdn2d_bwd_cuda.launches - before[1])
                if plain:
                    check(counts == (0, 0), f"the plain DDPM path launched {counts}")
                else:
                    fwd_calls[name], bwd_calls[name] = list(rec[0][:S1_PER_FORWARD]), rec[1]
                    check(counts == (2 * S1_PER_FORWARD, S1_PER_FORWARD)
                          and {c[0] for c in rec[0] + rec[1]} <= {"same1", "same2"}
                          and {c[-1] for c in rec[0] + rec[1]} == {dtype},
                          f"{name} DDPM forward + gradient launched {counts}: "
                          f"{sorted({c[0] for c in rec[0] + rec[1]})}")
                    launched[(name, "fwd")] = {f"ddpm_forward_and_gradient_{name}": counts[0]}
                    launched[(name, "bwd")] = {f"ddpm_forward_and_gradient_{name}": counts[1]}
                runs.append((out.float(), [g.float() for g in grads]))
            (out_k, g_k), (out_p, g_p) = runs
            err = (out_k - out_p).abs().max().item()
            scale = out_p.abs().max().item()
            d_norm = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(g_k, g_p))).item()
            norm = torch.sqrt(sum((b ** 2).sum() for b in g_p)).item()
            tol = 1e-4 if dtype == torch.float32 else 1e-2
            print(f"  DDPM + residual NCSN++ {count_parameters(net)} params, {name}: forward "
                  f"(B=1, 256 x {FRAMES}) kernel vs plain max abs err {err:.3e} (scale "
                  f"{scale:.3e}); gradient (B={TRAIN_B}, 256 x {TRAIN_FRAMES}, input and "
                  f"{len(g_p) - 1} parameters) |diff| {d_norm:.3e} of norm {norm:.6e} "
                  f"({d_norm / norm:.3e}); launches per forward {S1_PER_FORWARD}, per backward "
                  f"{S1_PER_FORWARD} (module list)", flush=True)
            check(err <= tol * scale and d_norm <= tol * norm and bool(torch.isfinite(out_k).all()),
                  f"the {name} DDPM net through the kernels disagrees with plain")
            del net, runs, g_k, g_p
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False

    # the option through the entry points: a DDPM denoiser-only checkpoint, 1 forward per file
    ckpt = os.path.join(workdir, "ddpm_denoiser.pt")
    save_checkpoint(ckpt, DDPM_DENOISER, build_model(DDPM_DENOISER, device="cpu",
                                                     seed=0).state_dict())
    noisy = os.path.join(workdir, "noisy")
    for dtype in ("float32", "bfloat16"):
        out = os.path.join(workdir, f"enhanced_ddpm_{dtype}")
        with k1_calls_recorded() as (rec, _), calls_counted() as per_call:
            run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                             "--mode", "denoiser-only", "--dtype", dtype, "--device", "cuda"])
        seen = {c[-1] for c in rec}
        check_outputs(out, lengths)
        check(per_call == [(S1_PER_FORWARD, 0, 1)] * len(lengths)
              and seen == {torch.float32 if dtype == "float32" else BF16},
              f"the DDPM denoiser CLI in {dtype}: per file {per_call}, dtypes {seen}")
        launched[(dtype, "fwd")][f"enhancement_ddpm_denoiser_{dtype}"] = len(rec)
        print(f"  DDPM + residual denoiser-only checkpoint through the CLI in {dtype}: "
              f"{len(lengths)} files, (K1, K3, NFE) per file {per_call[0]}, outputs finite and "
              f"as long as the inputs", flush=True)
    return fwd_calls, bwd_calls, launched


def phase_stride1_kernel(fwd_calls, bwd_calls, gen: torch.Generator):
    """Phase 60. The stride-1 instance and its adjoint against plain at every
    shape phase 59's forward (B=1, 256 x 576) and backward (B=8, 256 x 256)
    gave them, in f32 (atol = rtol = 1e-5) and bf16 (`compare`'s allowance;
    equal with NCSN++'s FIR), NCSN++'s and an asymmetric FIR; each shape
    timed (CUDA events back to back, the profiler's device time after an
    L2-clearing read) beside the plain version, the depthwise `conv2d` that
    computes the same function and the bound (bytes once at 3.35 TB/s, 4 B
    per f32 element, 2 per bf16), and their sums per forward and per
    backward. Each shape's line names the paths its launch took
    (`kup.launch_plan`: the box by TMA or by row copies; the stride-1
    instance stores warp rows, never lane-strided elements); the phase fails
    if one of them loads element by element. Returns {(dtype, direction):
    (per-shape times, the calls as keys, max error, {load / store path:
    calls})}."""
    out = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", BF16)):
        for direction, calls in (("fwd", fwd_calls[name]), ("bwd", bwd_calls[name])):
            per_shape, launch, by_path = {}, {}, {}
            keys = [(cfg, C, H, W) for cfg, _, C, H, W, _ in calls]
            B = calls[0][1]
            if direction == "fwd":
                err = check_k1_at(f"the DDPM forward ({name})", set(calls), gen)
            else:
                err = check_k1_bwd_at(f"the DDPM backward ({name})", set(calls), gen)
            for cfg, C, H, W in dict.fromkeys(keys):
                c = CONFIGS[cfg]
                args = dict(up=1, down=1, pad=c["pad"])
                Ho, Wo = (kup.output_size(n, 4, 1, 1, c["pad"]) for n in (H, W))
                x = torch.randn(B, C, H, W, device="cuda", generator=gen).to(dtype)
                if direction == "fwd":
                    inp, run = x, functools.partial(kup.upfirdn2d_cuda, x, c["kernel"], **args)
                    plain = functools.partial(kup.upfirdn2d_plain, x, c["kernel"], **args)
                    lib = library_call(cfg, C, dtype=dtype)
                    n_out = C * Ho * Wo * B
                else:
                    g = torch.randn(B, C, Ho, Wo, device="cuda", generator=gen).to(dtype)
                    bwd = (g, c["kernel"], 1, 1, c["pad"], (H, W))
                    inp, run = g, functools.partial(kup.upfirdn2d_bwd_cuda, *bwd)
                    plain = functools.partial(kup.upfirdn2d_bwd_plain, *bwd)
                    lib = library_call(cfg, C, backward=True, dtype=dtype)
                    n_out = x.numel()
                want = plain()
                plan = kup.launch_plan(
                    inp, want, 1, 1, c["pad"][0] if direction == "fwd" else 3 - c["pad"][0])
                path = " / ".join(kup.paths(plan, 1, 1))
                check(plan.tma or plan.rows,
                      f"upfirdn2d stride 1 {direction} {cfg} C={C} {H}x{W} {name}: {path}")
                by_path[path] = by_path.get(path, 0) + keys.count((cfg, C, H, W))
                lib_err = (lib(inp) - want).abs().max().item()
                check(lib(inp).shape == want.shape
                      and lib_err <= (1e-5 if dtype == torch.float32 else 1e-2)
                      * (1 + want.float().abs().max().item()),
                      f"the depthwise conv2d yardstick {cfg} C={C}: not the same function "
                      f"({lib_err:.3e})")
                bytes_ms, ops_ms = bound_ms(inp.numel(), n_out, 16, inp.element_size())
                per_shape[(cfg, C, H, W)] = dict(
                    ms=time_ms(run), plain_ms=time_ms(plain, reps=5),
                    library_ms=time_ms(lambda: lib(inp)), bytes_ms=bytes_ms, ops_ms=ops_ms,
                    lib_err=lib_err, out=f"{tuple(want.shape[-2:])}", path=path)
                launch[(cfg, C, H, W)] = run
            what = f"upfirdn2d stride 1{' adjoint' if direction == 'bwd' else ''} {name}"
            print_per_shape(f"{what} (B={B})", per_shape, launch, "upfirdn2d_same1", keys,
                            "DDPM score " + ("forward" if direction == "fwd" else "backward"))
            print(f"  {what}: calls by path (load / store) {by_path}", flush=True)
            out[(name, direction)] = (per_shape, keys, err, by_path)
            torch.cuda.empty_cache()
    return out


@functools.lru_cache(maxsize=None)
def large_structure():
    """StoRM's denoiser and an ncsnpplarge score net, for their module lists."""
    return (NCSNpp(input_channels=2, discriminative=True),
            backbones.get_by_name("ncsnpplarge")(input_channels=6))


def phase_ncsnpplarge(workdir: str, lengths, gen: torch.Generator):
    """Phase 61. A full-width ncsnpplarge score net (65.6M parameters, seven
    levels, two resblocks a level, attention at 16): one forward on the 1 s
    and 4 s buckets (192 and 576 frames: its deepest level 3 and 9 frames
    wide, rows the producer warp copies, not TMA) through the kernels, with
    the module list's 36 launches each, and K1 and its adjoint against
    plain at every shape, f32 and bf16. Then StoRM with it as score net
    (phase 5's denoiser) through `python -m storm_tpu_torch.enhancement` on
    phase 5's files, N=4 + ald (18 + 36 x 8 launches per file), and its
    captured program at the 4 s bucket against the eager loop, bit for bit.
    Returns ({path: K1 launches}, K1's max error in f32, in bf16)."""
    net = large_structure()[1]
    reset_parameters(net, torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    check(k1_per_forward(net) == LARGE_PER_FORWARD,
          f"ncsnpplarge's module list gives {k1_per_forward(net)} calls")
    shapes = set()
    for frames in (padded_frames(1.0), FRAMES):
        x = 0.5 * torch.randn(1, 3, FREQS, frames, 2, device="cuda", generator=gen)
        before = kup.upfirdn2d_cuda.launches
        with torch.inference_mode(), k1_calls_recorded() as (rec, _):
            out = net(x, torch.full((1,), 0.5, device="cuda"))
        torch.cuda.synchronize()
        check(kup.upfirdn2d_cuda.launches - before == LARGE_PER_FORWARD
              and bool(torch.isfinite(out).all()),
              f"an ncsnpplarge forward at {frames} frames launched "
              f"{kup.upfirdn2d_cuda.launches - before}")
        widths = sorted({c[4] for c in rec})
        print(f"  ncsnpplarge {count_parameters(net)} params, 256 x {frames}: "
              f"{LARGE_PER_FORWARD} upfirdn2d launches (module list {k1_per_forward(net)}); "
              f"input widths {widths}", flush=True)
        shapes |= {c[:-1] for c in rec}
    errs = {}
    for dt in (torch.float32, BF16):
        at = {(*c, dt) for c in shapes}
        what = f"ncsnpplarge's forwards ({str(dt).split('.')[-1]})"
        errs[dt] = max(check_k1_at(what, at, gen), check_k1_bwd_at(what, at, gen))
    del net
    torch.cuda.empty_cache()

    ckpt = os.path.join(workdir, "storm_large.pt")
    model = build_model(LARGE_STORM, device="cuda", seed=0)
    save_checkpoint(ckpt, LARGE_STORM, model.state_dict())
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced_large")
    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (k1s, _), calls_counted() as per_call:
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--timeit", "--device", "cuda",
                                "--N", str(N_STEPS)])
    check_outputs(out, lengths)
    want = (K1_PER_FORWARD + LARGE_PER_FORWARD * (NFE - 1), 0, NFE)
    check(per_call == [want] * len(lengths), f"the ncsnpplarge StoRM CLI: per file {per_call}")
    paths = {"enhancement_ncsnpplarge_float32": kup.upfirdn2d_cuda.launches}
    errs[torch.float32] = max(errs[torch.float32], check_k1_at("the ncsnpplarge StoRM CLI",
                                                               k1s, gen))
    rtf = rtf_of(text)
    print(f"  StoRM with an ncsnpplarge score net through the CLI (f32, N={N_STEPS} + ald): "
          f"(K1, K3, NFE) per file {per_call[0]}; RTF "
          + ", ".join(f"{n} {rtf[n]:.4f}" for n in lengths), flush=True)
    y = load_wav(os.path.join(noisy, f"utt2_{SECONDS[2]:.1f}s.wav"))[0][0]
    row, _, _ = graph_against_eager(f"storm ncsnpplarge pc N={N_STEPS} f32, 4 s", model, y,
                                    y.shape[-1] / SR, [], N=N_STEPS, corrector="ald")
    paths["graph_against_eager_ncsnpplarge_float32"] = row["k1"]
    del model
    torch.cuda.empty_cache()
    return paths, errs[torch.float32], errs[BF16]


def phase_ncsnpplarge_train(train_dir: str, gen: torch.Generator):
    """Phase 62. `python -m storm_tpu_torch.train --backbone_score
    ncsnpplarge --dtype bfloat16` on phase 8's corpus, one epoch of 4 steps
    at B=8 x 256 frames, through its programs: phase_train's checks (18 + 36
    forward and 15 + 36 backward launches per step, from the module lists),
    its step and peak memory. Then one eager float32 step of the same model
    at B=8, or, if it runs out of memory, at the largest of 4 and 2 that
    fits: its peak memory. Returns phase_train's dict and the f32 row."""
    r = phase_train(train_dir, "bfloat16", steps_total=TRAIN_FILES // TRAIN_B,
                    extra=("--backbone_score", "ncsnpplarge"), structure=large_structure())
    print(f"  bf16 StoRM with an ncsnpplarge score net at B={TRAIN_B}: step {r['step_ms']:.2f} "
          f"ms, peak of the steps {r['step_peak_gib']:.2f} GiB allocated, "
          f"{r['reserved_gib']:.2f} GiB reserved", flush=True)
    torch.cuda.empty_cache()
    f32 = None
    for B in (TRAIN_B, 4, 2):
        model = state = None
        try:
            torch.cuda.reset_peak_memory_stats()
            model = build_model(LARGE_STORM, device="cuda", seed=0).train()
            state = init_train_state(model, model.lr)
            x = 0.3 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
            y = x + 0.2 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
            t0 = time.perf_counter()
            aux = model.train_step(state, (x, y), gen)
            loss = float(aux["loss"])
            f32 = dict(B=B, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       s=time.perf_counter() - t0, loss=loss)
        except torch.cuda.OutOfMemoryError:
            print(f"  one f32 step at B={B} ran out of memory", flush=True)
        finally:
            del model, state
            torch.cuda.empty_cache()
        if f32 is not None:
            break
    check(f32 is not None and np.isfinite(f32["loss"]), "no f32 ncsnpplarge step fits")
    print(f"  one eager f32 step of StoRM with an ncsnpplarge score net at B={f32['B']}: "
          f"{f32['s']:.3f} s (its first: kernels and cuDNN plans included), peak "
          f"{f32['peak_gib']:.2f} GiB allocated", flush=True)
    return r, f32


def phase_convtasnet_train(train_dir: str):
    """Phase 63. `python -m storm_tpu_torch.train --mode denoiser-only
    --backbone_denoiser convtasnet --return_time --loss_type sisdr` (the
    reference's width: 256 filters, 8 x 3 blocks) on phase 8's corpus, one
    epoch of 4 steps at B=8 of 32640 samples, in f32, through its programs:
    finite losses, every tensor moved, no upfirdn2d launch; its checkpoint
    enhances a file through the CLI."""
    r = phase_train(train_dir, "float32", steps_total=TRAIN_FILES // TRAIN_B, mode="denoiser-only",
                    extra=("--backbone_denoiser", "convtasnet", "--return_time", "--loss_type",
                           "sisdr"), structure=(backbones.get_by_name("convtasnet")(),))
    check(r["launches"] == (0, 0), f"ConvTasNet's training launched upfirdn2d {r['launches']}")
    return r


def phase_time_domain_storm(workdir: str, lengths, gen: torch.Generator):
    """Phase 64. StoRM with a ConvTasNet and with an ae-ncsnpp denoiser (the
    reference's widths, seeded random weights; the score net phase 5's
    NCSN++) through `python -m storm_tpu_torch.enhancement` on phase 5's
    files at N=4 + ald: outputs finite and as long as the inputs, per file
    the score net's 18 launches per forward and the denoiser's (ConvTasNet
    none, ae-ncsnpp's trunk 18, from the module lists); then the ConvTasNet
    StoRM through the server at its bf16 default on phase 15's burst, with
    exact launches per call. Returns ({path: K1 launches} in f32, in bf16,
    K1's max error in f32, in bf16)."""
    noisy = os.path.join(workdir, "noisy")
    f32_paths, shapes = {}, set()
    for denoiser in TIME_DOMAIN:
        config = {**STORM_CONFIG, "backbone_denoiser": denoiser}
        model = build_model(config, device="cpu", seed=0)
        ckpt = os.path.join(workdir, f"storm_{denoiser}.pt")
        save_checkpoint(ckpt, config, model.state_dict())
        den = k1_per_forward(model.denoiser_net)
        check(den == (18 if denoiser == "ae-ncsnpp" else 0),
              f"the {denoiser} denoiser's module list gives {den} calls")
        out = os.path.join(workdir, f"enhanced_{denoiser}")
        kup.upfirdn2d_cuda.launches = 0
        with shapes_recorded() as (k1s, _), calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "storm", "--timeit", "--device", "cuda",
                                    "--N", str(N_STEPS)])
        check_outputs(out, lengths)
        want = (den + K1_PER_FORWARD * (NFE - 1), 0, NFE)
        check(per_call == [want] * len(lengths), f"StoRM with {denoiser}: per file {per_call}")
        f32_paths[f"enhancement_{denoiser}_float32"] = kup.upfirdn2d_cuda.launches
        shapes |= k1s
        rtf = rtf_of(text)
        print(f"  StoRM with a {denoiser} denoiser ({count_parameters(model.denoiser_net)} "
              f"params) through the CLI (f32, N={N_STEPS} + ald): (K1, K3, NFE) per file "
              f"{per_call[0]}; RTF " + ", ".join(f"{n} {rtf[n]:.4f}" for n in lengths),
              flush=True)
    err = check_k1_at("the time-domain StoRM CLI runs", shapes, gen)
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    srv = run_server("ConvTasNet StoRM server (bf16)",
                     serve_args(os.path.join(workdir, "storm_convtasnet.pt")), waves)
    want = K1_PER_FORWARD * (SERVE_NFE - 1) * (srv["warmups"] + srv["stats"]["batches"])
    check(srv["k1"] == want, f"the ConvTasNet StoRM server launched {srv['k1']}, expected {want}")
    print(f"  ConvTasNet StoRM server: upfirdn2d launches {srv['k1']} (the score net's "
          f"{K1_PER_FORWARD} x {SERVE_NFE - 1} per warm-up call and batch)", flush=True)
    err_bf16 = check_k1_at("the ConvTasNet StoRM server", srv["k1_shapes"], gen)
    return f32_paths, {"server_convtasnet_bf16": srv["k1"]}, err, err_bf16


# --- phases 65-68: GaGNet and the reference-checkpoint converters

GAGNET_STORM = {**STORM_CONFIG, "backbone_denoiser": "gagnet"}


@functools.lru_cache(maxsize=None)
def gagnet_structure():
    """GaGNet at the reference CLI's defaults, for `step_launches` (it calls
    no K1)."""
    return backbones.get_by_name("gagnet")()


def phase_gagnet(gen: torch.Generator):
    """Phase 65. Returns the rows {bucket s: figures}."""
    net = backbones.get_by_name("gagnet")()
    reset_parameters(net, torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    rows = {}
    for s in SECONDS:
        frames = padded_frames(s)
        x = 0.3 * torch.randn(1, 1, FREQS, frames, 2, device="cuda", generator=gen)
        before = kup.upfirdn2d_cuda.launches
        with torch.inference_mode():
            out = net(x)
            f32_ms = time_ms(lambda: net(x), reps=5, repeats=3)
            net.dtype = BF16
            with cast_params(net, BF16):
                out_bf16 = net(x)
                bf16_ms = time_ms(lambda: net(x), reps=5, repeats=3)
            net.dtype = torch.float32
        torch.cuda.synchronize()
        scale = out.abs().max().item()
        rel = (out_bf16 - out).abs().max().item() / scale
        rel_l2 = ((out_bf16 - out).norm() / out.norm()).item()
        check(kup.upfirdn2d_cuda.launches == before, "GaGNet launched upfirdn2d")
        check(out.shape == x.shape and out_bf16.dtype == torch.float32
              and bool(torch.isfinite(out).all()) and bool(torch.isfinite(out_bf16).all()),
              f"GaGNet at {frames} frames gave {tuple(out.shape)}")
        # the reference's own bf16 GaGNet at this width parts from its f32 output by
        # 0.46 in L2 at 16 frames (tests/test_torch_gagnet.py::test_bf16_at_the_reference_
        # width_parts_from_f32_as_the_reference_does): a bound on the port's, not parity
        check(0.0 < rel_l2 <= 0.5, f"GaGNet bf16 parts from its f32 output by {rel_l2:.3e} "
              "in L2")
        rows[s] = dict(frames=frames, f32_ms=f32_ms, bf16_ms=bf16_ms, bf16_rel=rel,
                       bf16_rel_l2=rel_l2)
        print(f"  GaGNet ({count_parameters(net)} params) on the {s} s bucket (256 x {frames}): "
              f"forward {f32_ms:.3f} ms f32, {bf16_ms:.3f} ms bf16; bf16 against f32: "
              f"{rel_l2:.3e} in L2, {rel:.3e} of scale {scale:.3e} at the worst element; no "
              "upfirdn2d launch", flush=True)
    # one captured replay at the 4 s bucket against the eager forward
    x = 0.3 * torch.randn(1, 1, FREQS, FRAMES, 2, device="cuda", generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        with torch.cuda.stream(side):
            net(x)  # cuDNN's plans and workspaces, off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = net(x)
        graph.replay()
        eager = net(x)
    torch.cuda.synchronize()
    err = (static - eager).abs().max().item()
    print(f"  GaGNet's captured forward at 256 x {FRAMES}: max|replay - eager| {err:.3e}",
          flush=True)
    check(err == 0.0, f"GaGNet's replay parts from its eager forward by {err:.3e}")
    del net, graph, static
    torch.cuda.empty_cache()
    return rows


def phase_gagnet_storm(workdir: str, lengths, gen: torch.Generator):
    """Phase 66. Returns ({path: K1 launches} f32, bf16, {path: K3 launches}
    bf16, K1's max error f32, bf16, K3's, and the RTF rows)."""
    noisy = os.path.join(workdir, "noisy")
    model = build_model(GAGNET_STORM, device="cpu", seed=0)
    ckpt = os.path.join(workdir, "storm_gagnet.pt")
    save_checkpoint(ckpt, GAGNET_STORM, model.state_dict())
    del model
    k1, k3, shapes, k3_shapes, rtfs = {}, {}, {}, set(), {}
    for tag, extra in (("float32", ()), ("bfloat16", ("--dtype", "bfloat16")),
                       ("int8_bfloat16", ("--dtype", "bfloat16", "--quant", "int8"))):
        out = os.path.join(workdir, f"enhanced_gagnet_{tag}")
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                    "--mode", "storm", "--timeit", "--device", "cuda",
                                    "--N", str(N_STEPS), *extra])
        check_outputs(out, lengths)
        int8 = "int8" in tag
        want = (K1_PER_FORWARD * (NFE - 1), N_QUANT * (NFE - 1) if int8 else 0, NFE)
        check(per_call == [want] * len(lengths),
              f"StoRM with GaGNet ({tag}): (K1, K3, NFE) per file {per_call}, expected {want}")
        if int8:
            check(f"int8 calibration done ({N_QUANT} convs quantized" in text,
                  "the GaGNet StoRM calibration did not quantize the score net's convs alone")
            k3[f"enhancement_gagnet_{tag}"] = kq.quantize_int8_cuda.launches
            k3_shapes |= k3s
        k1[f"enhancement_gagnet_{tag}"] = kup.upfirdn2d_cuda.launches
        shapes.setdefault(tag == "float32", set()).update(k1s)
        rtfs[tag] = rtf_of(text)
        print(f"  StoRM with a GaGNet denoiser through the CLI ({tag}, N={N_STEPS} + ald): "
              f"(K1, K3, NFE) per file {per_call[0]}; RTF "
              + ", ".join(f"{n} {rtfs[tag][n]:.4f}" for n in lengths), flush=True)
    err = check_k1_at("the GaGNet StoRM CLI (f32)", shapes[True], gen)
    err_bf16 = check_k1_at("the GaGNet StoRM CLI (bf16)", shapes[False], gen)
    k3_err = check_k3_at("the GaGNet StoRM CLI (int8 + bf16)", k3_shapes, gen)
    # pc + ald at N=GRAPH_N, at 4 s in bf16: the captured program against eager
    model = build_model(dict(GAGNET_STORM, dtype="bfloat16"), device="cuda", seed=0)
    y = load_wav(os.path.join(noisy, f"utt2_{SECONDS[2]:.1f}s.wav"))[0][0]
    row, _, _ = graph_against_eager(f"storm gagnet pc N={GRAPH_N} bf16, 4 s", model, y,
                                    y.shape[-1] / SR, [], N=GRAPH_N, corrector="ald")
    k1["graph_against_eager_gagnet_bfloat16"] = row["k1"]
    rtfs[f"graph_n{GRAPH_N}_bfloat16"] = row
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    srv = run_server("GaGNet StoRM server (bf16)", serve_args(ckpt), waves)
    want = K1_PER_FORWARD * (SERVE_NFE - 1) * (srv["warmups"] + srv["stats"]["batches"])
    check(srv["k1"] == want, f"the GaGNet StoRM server launched {srv['k1']}, expected {want}")
    k1["server_gagnet_bfloat16"] = srv["k1"]
    err_bf16 = max(err_bf16, check_k1_at("the GaGNet StoRM server", srv["k1_shapes"], gen))
    f32 = {k: v for k, v in k1.items() if k.endswith("float32")}
    bf16 = {k: v for k, v in k1.items() if not k.endswith("float32")}
    return f32, bf16, k3, err, err_bf16, k3_err, rtfs


def phase_gagnet_train(train_dir: str):
    """Phase 67. Returns {run: phase_train's dict}."""
    steps = TRAIN_FILES // TRAIN_B
    runs = {"train_storm_gagnet_bf16": phase_train(
        train_dir, "bfloat16", steps_total=steps, extra=("--backbone_denoiser", "gagnet"),
        structure=(gagnet_structure(), storm_structure()[1]))}
    for norm in ("IN", "BN"):
        r = phase_train(train_dir, "float32", steps_total=steps, mode="denoiser-only",
                        extra=("--backbone_denoiser", "gagnet", "--norm_type", norm),
                        structure=(gagnet_structure(),))
        check(r["launches"] == (0, 0), f"GaGNet's training launched upfirdn2d {r['launches']}")
        runs[f"train_denoiser_gagnet_{norm}"] = r
    print(f"  GaGNet trainers at B={TRAIN_B} x {TRAIN_FRAMES}: " + "; ".join(
        f"{k} step {r['step_ms']:.2f} ms, peak of the steps {r['step_peak_gib']:.2f} GiB, "
        f"upfirdn2d launches (fwd, bwd) in all {r['launches']}" for k, r in runs.items()),
        flush=True)
    return runs


def phase_gagnet_bn_checkpoint(workdir: str, lengths):
    """Phase 68. Returns the rows of the check."""
    config = {"mode": "denoiser-only", "backbone_denoiser": "gagnet", "norm_type": "BN"}
    model = build_model(config, device="cpu", seed=0)
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in model.dnn.state_dict().items():
        sd["dnn." + k] = v
        if k.endswith(".norm.bias"):  # torch BatchNorm's buffers, after its affine
            stem = "dnn." + k[: -len("bias")]
            sd[stem + "running_mean"] = torch.from_numpy(
                (0.1 * rng.standard_normal(v.shape)).astype(np.float32))
            sd[stem + "running_var"] = torch.from_numpy(
                (0.5 + rng.random(v.shape)).astype(np.float32))
            sd[stem + "num_batches_tracked"] = torch.tensor(100)
    trainable = [k for k in sd if k.split(".")[-1] not in BN_BUFFERS]
    shadow = [sd[k] + torch.from_numpy((0.01 * rng.standard_normal(tuple(sd[k].shape))).astype(
        np.float32)) for k in trainable]
    hparams = {"backbone": "gagnet", "norm_type": "BN", "n_fft": 510, "hop_length": 128,
               "window": "hann", "spec_factor": 0.15, "spec_abs_exponent": 0.5,
               "loss_type": "mse"}
    ref_ckpt = os.path.join(workdir, "gagnet_bn.ckpt")
    torch.save({"state_dict": sd, "ema": {"shadow_params": shadow},
                "hyper_parameters": hparams}, ref_ckpt)
    del model
    pt = os.path.join(workdir, "gagnet_bn.pt")
    text = captured(ref_convert.main, ["--ckpt", ref_ckpt, "--out", pt,
                                       "--mode", "denoiser-only"])[1]
    check(f"BatchNorm running stats saved to {batch_stats_path(pt)}" in text,
          "the converter wrote no side file")
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced_gagnet_bn")
    outputs = {}
    kup.upfirdn2d_cuda.launches = 0
    text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", pt,
                            "--mode", "denoiser-only", "--timeit", "--device", "cuda"], outputs)
    check(f"BatchNorm running stats loaded from {batch_stats_path(pt)}" in text,
          "the enhancement CLI did not load the side file")
    check_outputs(out, lengths)
    check(kup.upfirdn2d_cuda.launches == 0, "the GaGNet denoiser launched upfirdn2d")
    served = served_model(pt)
    stats = captured(load_gagnet_batch_stats, pt, served)[0]
    check(torch.equal(served.dnn.en.last_conv[2].weight.cpu(),
                      shadow[trainable.index("dnn.en.last_conv.2.weight")]),
          "the converted checkpoint does not serve the EMA weights")
    rows = {}
    for name, n in lengths.items():
        y = bucketed(load_wav(os.path.join(noisy, name))[0])
        want = served.enhance(y, batch_stats=stats)[0][..., :n].cpu().numpy()
        plain = served.enhance(y)[0][..., :n].cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(outputs[name] - want[0]).max())
        moved = float(np.abs(plain - want).max())
        rows[name] = dict(err=err, scale=scale, batch_stats_moved=moved)
        check(err <= 1e-5 * scale, f"{name}: the CLI parts from enhance with the stats by {err:.3e}")
        check(moved > 1e-3 * scale, f"{name}: the running statistics changed nothing ({moved:.3e})")
    print("  the converted GaGNet-BN checkpoint through the CLI against the model's enhance "
          "with its running statistics: " + "; ".join(
              f"{k} max|diff| {r['err']:.3e} (scale {r['scale']:.3e}; the batch's statistics "
              f"move it by {r['batch_stats_moved']:.3e})" for k, r in rows.items()), flush=True)
    corpus = os.path.join(workdir, "train", "corpus")
    write_test_split(corpus)
    out_csv = os.path.join(workdir, "evaluate_gagnet_bn.csv")
    text = captured(evaluate.main, [
        "--ckpt", pt, "--mode", "denoiser-only", "--base_dir", corpus, "--num_files",
        str(len(BATCH_SECONDS)), "--batch", str(EVAL_BATCH), "--csv", out_csv,
        "--device", "cuda"])[1]
    with open(out_csv) as f:
        csv_rows = list(csv.DictReader(f))
    check("BatchNorm running stats loaded from" in text and len(csv_rows) == len(BATCH_SECONDS)
          and all(np.isfinite(float(r["si_sdr"])) and np.isfinite(float(r["estoi"]))
                  for r in csv_rows), f"evaluate with the GaGNet-BN checkpoint: {csv_rows}")
    print(f"  evaluate --mode denoiser-only with it: {len(csv_rows)} rows, mean SI-SDR "
          f"{np.mean([float(r['si_sdr']) for r in csv_rows]):.3f} dB, ESTOI "
          f"{np.mean([float(r['estoi']) for r in csv_rows]):.4f}", flush=True)
    del served
    torch.cuda.empty_cache()
    return rows


# --- multichannel input (phases 69-70) and data-parallel training (phase 71)

D2 = 2  # the multichannel phases' spatial channels
D2_CONFIG = dict(STORM_CONFIG, spatial_channels=D2)
# phase 69's 2-channel requests to the server (seconds), from as many clients
D2_SERVE_SECONDS = (1.0, 2.5, 4.0, 4.0)
# phase 71: steps of each run, the global batch's rows per process
DP_STEPS, DP_PROCESSES = 3, 2
# phase 71's second pair of runs: GaGNet with BN at the reference CLI's width
DP_BN_FLAGS = ("--mode", "denoiser-only", "--backbone_denoiser", "gagnet", "--norm_type", "BN")
# the two-process BN gradients' distance from the float64 step, against the
# one process's: float32 rounding sets both (PERF.md §6)
DP_BN_F64_RATIO = 1.5
DP_TIMEOUT_S = 600


def synth_waves(seconds: float, i: int, rng: np.random.Generator, channels: int = D2):
    """`channels` channels of `synth_wav`, each its own tone and noise: (channels, n)."""
    return np.stack([synth_wav(seconds, i + 7 * c, rng) for c in range(channels)])


def write_d2_wavs(directory: str, seconds, prefix: str, seed: int):
    """One 2-channel synthesized file per entry of `seconds`; {name: samples}."""
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    lengths = {}
    for i, s in enumerate(seconds):
        name = f"{prefix}{i}_{s:.1f}s.wav"
        save_wav(os.path.join(directory, name), synth_waves(s, i, rng), SR)
        lengths[name] = int(s * SR)
    return lengths


def check_d2_outputs(out: str, lengths):
    for name, n in lengths.items():
        x, sr = load_wav(os.path.join(out, name))
        check(sr == SR and x.shape == (D2, n), f"{name}: output shape {x.shape}, expected "
                                               f"({D2}, {n})")
        check(bool(np.isfinite(x).all()), f"{name}: output not finite")


def phase_d2_serving(workdir: str, graph_rows, gen: torch.Generator):
    """Phase 69. Returns ({path: K1 launches} f32, bf16, {path: K3
    launches}, K1's max error f32, bf16, K3's)."""
    model = build_model(D2_CONFIG, device="cpu", seed=0)
    ckpt = os.path.join(workdir, "storm_d2.pt")
    save_checkpoint(ckpt, D2_CONFIG, model.state_dict())
    del model
    noisy = os.path.join(workdir, "noisy_d2")
    lengths = write_d2_wavs(noisy, SECONDS, "d2_", seed=6)
    base = ["--test_dir", noisy, "--ckpt", ckpt, "--mode", "storm", "--timeit",
            "--device", "cuda"]
    stream_dir = os.path.join(workdir, "stream_noisy_d2")
    stream = write_d2_wavs(stream_dir, (STREAM_S,), "long_d2_", seed=8)
    bf16 = ("--dtype", "bfloat16")
    k1, k3, shapes, k3_shapes = {}, {}, {True: set(), False: set()}, set()
    # (path, N, files, enhancer calls: one a file, one a bucket of --batch rows,
    # one for the 12 s file's 8 chunks, extra flags)
    for tag, n_steps, files, calls, extra in (
            ("float32", N_STEPS, lengths, len(SECONDS), ()),
            ("bfloat16", N_STEPS, lengths, len(SECONDS), bf16),
            ("int8_bfloat16", N_STEPS, lengths, len(SECONDS), (*bf16, "--quant", "int8")),
            (f"batch{CLI_BATCH}_bfloat16", SERVE_N, lengths, len(SECONDS),
             (*bf16, "--batch", str(CLI_BATCH))),
            ("streaming_bfloat16", SERVE_N, stream, 1,
             (*bf16, "--stream_chunk_s", str(STREAM_CHUNK_S), "--stream_overlap_s",
              str(STREAM_OVERLAP_S)))):
        out = os.path.join(workdir, f"enhanced_d2_{tag}")
        argv = base + ["--enhanced_dir", out, "--N", str(n_steps), *extra]
        if files is stream:
            argv[1] = stream_dir
        nfe = 1 + 2 * n_steps
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        t0 = time.perf_counter()
        with shapes_recorded() as (k1s, k3s), calls_counted() as per_call:
            text = run_enhancement(argv)
        wall = time.perf_counter() - t0
        check_d2_outputs(out, files)
        nq = (0, 0)
        if "int8" in tag:
            scales = quant_mod.load_scales(scale_cache_path(ckpt))
            nq = (n_quantized(scales["denoiser"]), n_quantized(scales["score"]))
            check(f"int8 calibration done ({sum(nq)} convs quantized" in text and min(nq) > 0,
                  f"the D=2 int8 calibration quantized {nq}")
            k3[f"enhancement_d2_{tag}"] = kq.quantize_int8_cuda.launches
            k3_shapes |= k3s
        want = (K1_PER_FORWARD * nfe, nq[0] + nq[1] * (nfe - 1), nfe)
        check(per_call == [want] * calls,
              f"D=2 {tag}: (K1, K3, NFE) per call {per_call}, expected {want} x {calls}")
        k1[f"enhancement_d2_{tag}"] = kup.upfirdn2d_cuda.launches
        shapes[tag == "float32"].update(k1s)
        rtf = rtf_of(text)
        print(f"  D={D2} {tag} through the CLI ({len(files)} file(s), N={n_steps} + ald): "
              f"{wall:.2f} s wall; (K1, K3, NFE) per call {per_call[0]} x {len(per_call)}"
              + (f"; RTF " + ", ".join(f"{n} {v:.4f}" for n, v in rtf.items()) if rtf else "")
              + (f"; {nq[0]} + {nq[1]} convs quantized" if nq[0] else ""), flush=True)
    check(any(s[2] == 2 * D2 * 3 for s in shapes[True]),
          f"no K1 call at the score net's {2 * D2 * 3}-channel input pyramid: {shapes[True]}")
    err = check_k1_at("the D=2 CLI (f32)", shapes[True], gen)
    err_bf16 = check_k1_at("the D=2 CLI, --batch and streaming (bf16)", shapes[False], gen)
    k3_err = check_k3_at("the D=2 int8 + bf16 CLI", k3_shapes, gen)

    # the server with 2-channel payloads (the first 2 of 3 channels) and a mono one
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--port", "0", "--batch", str(CLI_BATCH),
         "--N", str(SERVE_N), "--device", "cuda"])
    rng = np.random.default_rng(9)
    waves = [synth_waves(s, i, rng, channels=3) for i, s in enumerate(D2_SERVE_SECONDS)]
    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (srv_shapes, _):
        (httpd, batcher), _ = captured(serve.build_server, args)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = httpd.server_address[:2]
            health = json.loads(http_call(host, port, "GET", "/healthz")[2])
            with concurrent.futures.ThreadPoolExecutor(len(waves)) as pool:
                t0 = time.perf_counter()
                replies = list(pool.map(lambda w: http_call(host, port, "POST", "/enhance",
                                                            encode_wav_bytes(w, SR)), waves))
                wall = time.perf_counter() - t0
            mono = http_call(host, port, "POST", "/enhance", encode_wav_bytes(waves[0][0], SR))
            stats = json.loads(http_call(host, port, "GET", "/stats")[2])
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(timeout=60)
    torch.cuda.synchronize()
    for (status, headers, payload, _), w in zip(replies, waves):
        check(status == 200, f"D=2 server: reply {status}: {payload[:300]!r}")
        x, _ = decode_wav_bytes(payload)
        check(x.shape == (D2, w.shape[-1]) and bool(np.isfinite(x).all())
              and int(headers["X-NFE"]) == SERVE_NFE, f"D=2 server: a reply of {x.shape}")
    check(mono[0] == 400 and b"1 channels, model needs 2" in mono[2],
          f"D=2 server: a mono payload got {mono[0]} {mono[2][:200]!r}")
    check(health["spatial_channels"] == D2 and stats["spatial_channels"] == D2
          and stats["requests"] == len(waves) and stats["errors"] == 0,
          f"D=2 server: /healthz {health.get('spatial_channels')}, /stats {stats}")
    want = K1_PER_FORWARD * SERVE_NFE * stats["batches"]
    check(kup.upfirdn2d_cuda.launches == want,
          f"the D=2 server launched {kup.upfirdn2d_cuda.launches}, expected {want}")
    k1["server_d2_bfloat16"] = want
    audio_s = sum(w.shape[-1] for w in waves) / SR
    print(f"  D={D2} server (bf16, N={SERVE_N}): {len(waves)} 3-channel requests served on "
          f"their first 2 in {stats['batches']} batches, {audio_s / wall:.4f} audio s per wall "
          f"s; a mono payload answered {mono[0]}; /healthz and /stats spatial_channels "
          f"{health['spatial_channels']}", flush=True)
    err_bf16 = max(err_bf16, check_k1_at("the D=2 server", srv_shapes, gen))

    # N=10 + ald at 2.5 s in bf16: the captured program against eager, beside
    # phase 54's D=1 row of this run
    model = build_model(dict(D2_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    y = load_wav(os.path.join(noisy, f"d2_1_{SECONDS[1]:.1f}s.wav"))[0]
    row, _, _ = graph_against_eager(f"storm D={D2} pc N={GRAPH_N} bf16, {SECONDS[1]:g} s",
                                    model, y, y.shape[-1] / SR, [], N=GRAPH_N, corrector="ald")
    k1["graph_against_eager_d2_bfloat16"] = row["k1"]
    d1 = next(r for r in graph_rows if r["what"] == f"storm pc N=10 bf16, {SECONDS[1]:g} s")
    print(f"  N={GRAPH_N} + ald bf16 at {SECONDS[1]:g} s: D={D2} replay RTF "
          f"{row['graph_rtf']:.4f} against D=1's {d1['graph_rtf']:.4f} (phase 54, this run; "
          f"{row['graph_rtf'] / d1['graph_rtf']:.3f}x); eager {row['eager_rtf']:.4f} against "
          f"{d1['eager_rtf']:.4f}", flush=True)
    del model
    torch.cuda.empty_cache()
    f32 = {k: v for k, v in k1.items() if k.endswith("float32")}
    bf16 = {k: v for k, v in k1.items() if not k.endswith("float32")}
    return f32, bf16, k3, err, err_bf16, k3_err


def phase_d2_train(workdir: str, train_bf16, gen: torch.Generator):
    """Phase 70. Returns (phase_train's dict, K1's bf16 error, its adjoint's)."""
    root = os.path.join(workdir, "train_d2")
    write_corpus(os.path.join(root, "corpus"), channels=D2)
    os.makedirs(os.path.join(root, "noisy_one"))
    save_wav(os.path.join(root, "noisy_one", "one.wav"),
             synth_waves(1.0, 3, np.random.default_rng(2)), SR)
    with shapes_recorded() as (k1s, _), adjoint_shapes_recorded() as bwds:
        r = phase_train(root, "bfloat16", steps_total=TRAIN_FILES // TRAIN_B,
                        extra=("--spatial_channels", str(D2)), tag="d2_")
    print(f"  D={D2} bf16 step {r['step_ms']:.2f} ms, peak of the steps "
          f"{r['step_peak_gib']:.2f} GiB, against D=1's {train_bf16['step_ms']:.2f} ms and "
          f"{train_bf16['step_peak_gib']:.2f} GiB (phase 25, this run; "
          f"{r['step_ms'] / train_bf16['step_ms']:.3f}x)", flush=True)
    return (r, check_k1_at("the D=2 trainer", k1s, gen),
            check_k1_bwd_at("the D=2 trainer", bwds, gen))


GATE_ENV = "CHIP_SMOKE_TRAIN_GATE"  # a file the train worker waits for before it trains


def train_worker(out: str, argv) -> None:
    """`python3 chip_smoke.py --train_worker OUT -- <train flags>` (phase 71):
    `python -m storm_tpu_torch.train` in this process, with every step timed
    between CUDA events (the loop gains no sync), the kernels' launches per
    step and the shapes given to upfirdn2d and its adjoint recorded, and the
    parameters after the first step and the gradients Adam read there (across
    processes: summed) written to OUT.step1.pt (by process 0);
    writes what it measured to OUT as JSON, with the wall-clock times at
    which it started, passed the gate (the file that GATE_ENV names, if set:
    its start-up overlaps another run's training), took its first step and
    ended its training."""
    times = {"start": time.time()}
    resolve_device("cuda")
    gate = os.environ.get(GATE_ENV)
    if gate:
        deadline = time.perf_counter() + DP_TIMEOUT_S
        while not os.path.exists(gate):
            check(time.perf_counter() < deadline, f"the train worker's gate {gate} never opened")
            time.sleep(0.05)
    times["gate"] = time.time()
    steps, runs = [], []
    original = train_graphs.TrainPrograms.step

    def timed_step(programs, arrays, generator):
        if not runs:
            runs.append(programs)
            times["first_step"] = time.time()
            if programs.world.is_main and batch_norms(programs.model):  # BN: phase 71's f64 step
                # the weights and the batch step 1 starts from
                torch.save({"params": {k: v.detach().cpu()
                                       for k, v in programs.model.state_dict().items()},
                            "batch": [torch.from_numpy(np.asarray(a)) for a in arrays]},
                           out + ".step0.pt")
        before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aux = original(programs, arrays, generator)
        end.record()
        steps.append(dict(start=start, end=end, launches=(
            kup.upfirdn2d_cuda.launches - before[0], kup.upfirdn2d_bwd_cuda.launches - before[1])))
        if len(steps) == 1 and programs.world.is_main:
            torch.save({"params": {k: v.detach().cpu()
                                   for k, v in programs.model.state_dict().items()},
                        "grads": [p.grad.detach().cpu() for p in programs.params]},
                       out + ".step1.pt")
        return aux

    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_graphs.TrainPrograms, "step", timed_step), \
            shapes_recorded() as (k1s, _), adjoint_shapes_recorded() as bwds:
        train.main(argv)
    torch.cuda.synchronize()
    times["trained"] = time.time()
    (programs,) = runs
    st = programs.stats
    record = dict(
        rank=programs.world.rank, size=programs.world.size, backend=programs.world.backend,
        periods_ms=[steps[i - 1]["end"].elapsed_time(steps[i]["end"])
                    for i in range(1, len(steps))],
        calls_ms=[s["start"].elapsed_time(s["end"]) for s in steps],
        launches=[s["launches"] for s in steps],
        totals=(kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
        execution=programs.execution,
        allreduce_ms=1e3 * st["allreduce_s"] / max(st["allreduces"], 1),
        allreduces=st["allreduces"], captures=st["captures"], replays=st["replays"],
        flat_mib=(programs.flat.numel() * 4 / 2 ** 20 if programs.flat is not None else 0),
        k1_shapes=[[*s[:-1], str(s[-1])] for s in k1s],
        bwd_shapes=[[*s[:-1], str(s[-1])] for s in bwds], times=times)
    with open(out, "w") as f:
        json.dump(record, f)


def _shapes(rows):
    return {(*r[:-1], getattr(torch, r[-1].split(".")[-1])) for r in rows}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """`processes` train workers started now (one without the STORM_TPU_*
    variables; several as one gloo group on a free port), each writing its
    output to a file; `gate`: a file they wait for before they train.
    `finish` waits for them (DP_TIMEOUT_S in all), prints their output and
    returns their records by rank; every process is stopped before it
    returns."""

    def __init__(self, argv, log_dir: str, out: str, processes: int, gate=None):
        self.out, self.processes, self.started = out, processes, time.time()
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if not k.startswith("STORM_TPU_")}
        if gate:
            env[GATE_ENV] = gate
        self.procs, self.logs = [], []
        try:
            for rank in range(processes):
                penv = dict(env) if processes == 1 else dict(
                    env, STORM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                    STORM_TPU_NUM_PROCESSES=str(processes), STORM_TPU_PROCESS_ID=str(rank))
                self.logs.append(open(f"{out}.{rank}.log", "w"))  # a full pipe cannot stall it
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--train_worker",
                     f"{out}.{rank}", "--", *argv, "--log_dir", log_dir],
                    env=penv, stdout=self.logs[-1], stderr=subprocess.STDOUT))
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def finish(self):
        try:
            deadline = self.started + DP_TIMEOUT_S
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            self.stop()
        texts = [open(f"{self.out}.{rank}.log").read() for rank in range(self.processes)]
        for rank, (p, text) in enumerate(zip(self.procs, texts)):
            print("".join(f"    | [{rank}] {line}\n" for line in text.splitlines()
                          if "socket.cpp" not in line), end="", flush=True)
            check(p.returncode == 0,
                  f"train worker {rank} of {self.processes} exited {p.returncode}")
        records = []
        for rank in range(self.processes):
            with open(f"{self.out}.{rank}") as f:
                records.append(json.load(f))
        return records, texts


def phase_data_parallel(workdir: str, gen: torch.Generator):
    """Phase 71. Returns ({path: K1 launches}, {path: K1-bwd launches}, K1's
    error, its adjoint's)."""
    train_dir = os.path.join(workdir, "train")
    corpus = os.path.join(train_dir, "corpus")  # phase 8's
    argv = ["--mode", "regen-joint-training", "--base_dir", corpus, "--format", "wsj0",
            "--batch_size", str(TRAIN_B), "--num_frames", str(TRAIN_FRAMES),
            "--max_steps", str(DP_STEPS), "--num_eval_files", "0", "--log_every_n_steps", "1",
            "--num_workers", "4", "--seed", "0", "--device", "cuda"]
    bn_argv = [*DP_BN_FLAGS, *argv[2:]]
    torch.cuda.empty_cache()
    # every run's processes start up while the one-process StoRM run trains,
    # and each trains after the one before it (its gate)
    names = ("one", "two", "bn_one", "bn_two")
    logs = {name: os.path.join(workdir, f"logs_dp_{name}") for name in names}
    gates = {name: os.path.join(workdir, f"dp_gate_{name}") for name in names[1:]}
    t0 = time.time()
    workers = {}
    try:
        for name in names[1:]:
            workers[name] = Workers(bn_argv if name.startswith("bn") else argv, logs[name],
                                    os.path.join(workdir, f"dp_{name}.json"),
                                    1 if name == "bn_one" else DP_PROCESSES, gate=gates[name])
        workers["one"] = Workers(argv, logs["one"], os.path.join(workdir, "dp_one.json"), 1)
        finished = {"one": workers["one"].finish()}
        for name in names[1:]:
            open(gates[name], "w").close()
            finished[name] = workers[name].finish()
    finally:
        for w in workers.values():
            w.stop()
    bn_runs = {name: finished.pop(name) for name in names[2:]}
    runs = {}
    for name, (records, texts) in finished.items():
        (run,) = os.listdir(logs[name])
        rows = [json.loads(line)
                for line in open(os.path.join(logs[name], run, "metrics.jsonl"))]
        runs[name] = dict(records=records, rows=rows, texts=texts,
                          ckpts=os.path.join(logs[name], run, "checkpoints"))
    one, two = runs["one"], runs["two"]
    for name, run in runs.items():
        times = [r["times"] for r in run["records"]]
        begin = t0 if name == "one" else max(t["gate"] for t in times)
        print(f"  {name} process(es): launch to the worker's start "
              f"{max(t['start'] for t in times) - t0:.1f} s; from "
              f"{'the launch' if name == 'one' else 'the gate'} to the first step "
              f"{max(t['first_step'] for t in times) - begin:.1f} s; the first step to the "
              f"trainer's end {max(t['trained'] - t['first_step'] for t in times):.1f} s",
              flush=True)
    check(all(f"process {r} of {DP_PROCESSES}: backend gloo on cuda" in two["texts"][r]
              for r in range(DP_PROCESSES)), "the two processes did not choose gloo on one card")
    check(all(r["backend"] == "gloo" and r["size"] == DP_PROCESSES for r in two["records"]),
          f"the workers' groups: {[(r['backend'], r['size']) for r in two['records']]}")
    # the losses of every step and the validation loss, as the reference's test holds them
    for key, rtol in (("train_loss", 5e-3), ("valid_loss", 1e-3)):
        a = [r[key] for r in one["rows"] if key in r]
        b = [r[key] for r in two["rows"] if key in r]
        rel = [abs(x - y) / abs(x) for x, y in zip(a, b)]
        print(f"  {key}: one process {[round(v, 4) for v in a]}, two {[round(v, 4) for v in b]}; "
              f"largest relative difference {max(rel):.3e} (held at {rtol})", flush=True)
        check(len(a) == len(b) == (DP_STEPS if key == "train_loss" else 1) and max(rel) <= rtol,
              f"{key}: two processes {b} against one {a}")
    # the first step's gradients, summed across the two processes, against
    # one process's: float32 sums in another order; a gradient left unsummed
    # is off by ~0.5 of the norm
    s1 = torch.load(os.path.join(workdir, "dp_one.json.0.step1.pt"))
    s2 = torch.load(os.path.join(workdir, "dp_two.json.0.step1.pt"))
    g1, g2 = s1["grads"], s2["grads"]
    check(len(g1) == len(g2) and all(a.shape == b.shape for a, b in zip(g1, g2)),
          "the two runs' gradients differ in their tensors")
    rel = float(torch.cat([(b - a).flatten() for a, b in zip(g1, g2)]).norm()
                / torch.cat([a.flatten() for a in g1]).norm())
    worst = max(float((b - a).norm() / max(float(a.norm()), 1e-30)) for a, b in zip(g1, g2))
    print(f"  gradients at step 1 (two processes summed, against one): |two - one| / |one| "
          f"{rel:.3e} over all {sum(a.numel() for a in g1)} elements (held at 1e-5), the "
          f"largest of one tensor {worst:.3e}", flush=True)
    check(rel <= 1e-5, f"the summed gradients part from one process's by {rel:.3e}")
    # after the first step: Adam's first step moves an element by lr times its
    # gradient's sign, so the runs agree within 2 lr (ROADMAP Queue 3)
    p1, p2 = s1["params"], s2["params"]
    lr = 1e-4
    diff = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
    near = sum(int(((p1[k] - p2[k]).abs() > 1e-6).sum()) for k in p1)
    print(f"  parameters after step 1: max |two - one| {diff:.3e} (held at 2 lr = {2 * lr:.0e}); "
          f"{near} of {sum(v.numel() for v in p1.values())} elements part by more than 1e-6",
          flush=True)
    check(diff <= 2 * lr, f"parameters after step 1 part by {diff:.3e}")
    check(sorted(os.listdir(two["ckpts"])) == ["best_loss.pt", "last.pt"]
          and len(two["rows"]) == len(one["rows"]),
          f"the two-process run wrote {os.listdir(two['ckpts'])} and {len(two['rows'])} rows")
    want = (STEP_FWD, STEP_BWD)  # per step, at the global batch's rows or this process's
    for name, run in runs.items():
        for r in run["records"]:
            # the one-process step is one program; across processes "grads" and
            # "update", each captured at its second call and replayed at the third
            programs = 1 if r["size"] == 1 else 2
            check(r["launches"] == [list(want)] * DP_STEPS
                  and r["totals"] == [STEP_FWD * (DP_STEPS + 1), STEP_BWD * DP_STEPS]
                  and r["captures"] == programs and r["replays"] == programs,
                  f"{name}, rank {r['rank']}: launches {r['launches']}, {r['totals']}; "
                  f"{r['captures']} captures, {r['replays']} replays")
            print(f"  {name} process(es), rank {r['rank']} of {r['size']} "
                  f"({r['backend'] or 'no group'}): step periods "
                  f"{[round(v, 2) for v in r['periods_ms']]} ms (the last a replay), calls "
                  f"{[round(v, 2) for v in r['calls_ms']]} ms; peak {r['peak_gib']:.2f} GiB "
                  f"allocated, {r['reserved_gib']:.2f} GiB reserved"
                  + (f"; all-reduce of {r['flat_mib']:.1f} MiB through the host "
                     f"{r['allreduce_ms']:.2f} ms per step ({r['allreduces']} steps)"
                     if r["size"] > 1 else "")
                  + f"; launches per step {r['launches'][-1]}, in all {r['totals']} (with "
                  f"the validation batch's forward)", flush=True)
    # only process 0 wrote the checkpoint; it serves
    out = os.path.join(workdir, "enhanced_dp")
    noisy = os.path.join(train_dir, "noisy_one")
    enhancement.main(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt",
                      os.path.join(two["ckpts"], "last.pt"), "--mode", "storm", "--N", "2",
                      "--device", "cuda"])
    x, _ = load_wav(os.path.join(noisy, "one.wav"))
    y, _ = load_wav(os.path.join(out, "one.wav"))
    check(y.shape == x.shape and bool(np.isfinite(y).all()),
          f"the two-process checkpoint enhanced to {y.shape}")
    print("  the two-process run's last.pt (written by process 0 alone) enhanced a 1 s file at "
          "N=2", flush=True)
    k1 = {f"train_dp_{name}_rank{r['rank']}": r["totals"][0]
          for name, run in runs.items() for r in run["records"]}
    bwd = {f"train_dp_{name}_rank{r['rank']}": r["totals"][1]
           for name, run in runs.items() for r in run["records"]}
    fwd_shapes = set().union(*(_shapes(r["k1_shapes"]) for r in two["records"]))
    bwd_shapes = set().union(*(_shapes(r["bwd_shapes"]) for r in two["records"]))
    check({s[1] for s in bwd_shapes} == {TRAIN_B // DP_PROCESSES},
          f"the two processes' backward rows {sorted({s[1] for s in bwd_shapes})}")
    data_parallel_bn(workdir, bn_runs, logs)
    return (k1, bwd, check_k1_at("the two-process trainer", fwd_shapes, gen),
            check_k1_bwd_at("the two-process trainer", bwd_shapes, gen))


def float64_gradients(start: str, ckpt: str):
    """The gradients of one step of the checkpoint's model at the weights and
    on the batch that `start` holds (a train worker's step0 file), the net
    computing in float64 (its parameters, its `dtype`) on the card."""
    config = load_training_checkpoint(ckpt)["config"]
    saved = torch.load(start)
    model = build_model(config, device="cuda", seed=0)
    model.load_state_dict(saved["params"])
    model = model.double().train()
    for name in model.NETS:
        getattr(model, name).dtype = torch.float64
    programs = train_graphs.TrainPrograms(init_train_state(model, 1e-4), graphs=False)
    programs.step([a.numpy().astype(np.float64) for a in saved["batch"]], None)
    grads = [p.grad.detach().cpu() for p in programs.params]
    del model, programs
    torch.cuda.empty_cache()
    return grads


def data_parallel_bn(workdir: str, finished, logs):
    """Phase 71's GaGNet-BN denoiser at the reference CLI's width: one
    process at B=TRAIN_B (its programs replayed) against DP_PROCESSES gloo
    processes at TRAIN_B / DP_PROCESSES rows each, whose BN moments span
    both (eager: `execution` says why): every step's loss and step 1's
    summed gradients. The validation loss is printed, not held: phase 8's
    validation batch is a ragged tail (VALID_FILES rows of TRAIN_B), padded
    with zero rows by one process and with the last file's rows repeated
    across processes, and BN's moments span the padding, in the reference
    as here."""
    runs = {}
    for name, (records, texts) in finished.items():
        (run,) = os.listdir(logs[name])
        rows = [json.loads(line)
                for line in open(os.path.join(logs[name], run, "metrics.jsonl"))]
        runs[name] = dict(records=records, rows=rows, texts=texts)
    one, two = runs["bn_one"], runs["bn_two"]
    executions = {name: sorted({r["execution"] for r in run["records"]})
                  for name, run in runs.items()}
    print(f"  GaGNet-BN denoiser-only ({' '.join(DP_BN_FLAGS[3:])}): execution, one process "
          f"{executions['bn_one']}, {DP_PROCESSES} processes {executions['bn_two']}", flush=True)
    check(executions == {"bn_one": ["graph"],
                         "bn_two": ["eager: BN moments across processes (gloo)"]},
          f"the BN runs' execution {executions}")
    a = [r["train_loss"] for r in one["rows"] if "train_loss" in r]
    b = [r["train_loss"] for r in two["rows"] if "train_loss" in r]
    rel = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    valid = [[r["valid_loss"] for r in run["rows"] if "valid_loss" in r] for run in (one, two)]
    print(f"  train_loss: one process {[round(v, 5) for v in a]}, {DP_PROCESSES} "
          f"{[round(v, 5) for v in b]}; largest relative difference {max(rel):.3e} (held at "
          f"5e-3); valid_loss (not held: the ragged batch's padding) {valid[0]} and {valid[1]}",
          flush=True)
    check(len(a) == len(b) == DP_STEPS and max(rel) <= 5e-3, f"BN train_loss: {b} against {a}")
    t0 = time.perf_counter()
    f64 = float64_gradients(os.path.join(workdir, "dp_bn_one.json.0.step0.pt"),
                            os.path.join(logs["bn_one"], os.listdir(logs["bn_one"])[0],
                                         "checkpoints", "last.pt"))
    print(f"  the float64 step on the one process's first batch: {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    s1 = torch.load(os.path.join(workdir, "dp_bn_one.json.0.step1.pt"))["grads"]
    s2 = torch.load(os.path.join(workdir, "dp_bn_two.json.0.step1.pt"))["grads"]
    check(len(s1) == len(s2) == len(f64)
          and all(x.shape == y.shape == z.shape for x, y, z in zip(s1, s2, f64)),
          "the BN runs' gradients differ in their tensors")
    # float32 rounding, amplified through the net's 169 BN layers, sets how
    # far any float32 step lies from the exact gradient (PERF.md §6): both
    # runs are held to the float64 step on the same weights and batch
    exact = torch.cat([g.flatten() for g in f64])
    e1, e2 = (float((torch.cat([g.double().flatten() for g in s]) - exact).norm()
                    / exact.norm()) for s in (s1, s2))
    rel = float(torch.cat([(y - x).flatten() for x, y in zip(s1, s2)]).norm()
                / torch.cat([x.flatten() for x in s1]).norm())
    print(f"  BN gradients at step 1, over {exact.numel()} elements: |two - one| / |one| "
          f"{rel:.3e}; from the float64 step, one process {e1:.3e}, {DP_PROCESSES} processes "
          f"summed {e2:.3e} ({e2 / e1:.2f}x, held at {DP_BN_F64_RATIO}x)", flush=True)
    check(e2 <= DP_BN_F64_RATIO * e1, f"the BN runs' summed gradients lie {e2:.3e} from the "
          f"float64 step, one process's {e1:.3e}")
    for name, run in runs.items():
        for r in run["records"]:
            print(f"  GaGNet-BN, rank {r['rank']} of {r['size']}: step periods "
                  f"{[round(v, 2) for v in r['periods_ms']]} ms, calls "
                  f"{[round(v, 2) for v in r['calls_ms']]} ms; peak {r['peak_gib']:.2f} GiB"
                  + (f"; gradient all-reduce {r['allreduce_ms']:.2f} ms a step"
                     if r["size"] > 1 else ""), flush=True)
            check(r["totals"] == [0, 0], f"GaGNet launched K1 {r['totals']}")


# --- phase 72: serving across devices, on one card


SP_KS = (2, 4)  # the sequence-parallel groups, their shards all on cuda:0
# more shards than the coarsest level holds frames: ncsnpplarge (7 levels:
# T / 64 frames there) at (frames, shards) = 1 coarse frame for 4 shards, 2
# for 4 and for 8; parts start on odd frames and hold none at the deep levels
SP_DEEP = ((64, 4), (128, 4), (128, 8))
SP_CLI_SHARDS = 4  # `--seq_parallel 4` on a 1 s file (192 frames: 3 coarse) with ncsnpplarge
SP_N = 1  # phase 72's sampler depth (its CLI runs too): N + ald, 3 forwards a call
SP_F32_FORWARD_RTOL = 1e-5  # sharded f32 forward against unsharded, of the output's scale
SP_F32_ENHANCE_RTOL = 1e-4  # sharded f32 enhancement (N=SP_N + ald), of the output's scale
# bf16 (and int8 + bf16): sharded against the f32 unsharded output, within
# this many times the unsharded bf16 output's distance from it: sharding
# reorders bf16 sums as a batch width does, and adds no error of its own
SP_BF16_RATIO = 2.0


def rel_err(got, want) -> float:
    got, want = (torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).float().cpu()
                 for v in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def sharded_k1_launches(net, frames: int, k: int) -> int:
    """K1 launches of one forward of `net` (BigGAN resblocks, output_skip and
    input_skip pyramids) over k shards of `frames` frames: each of a level
    change's 3 calls (a resampling resblock's 2, a pyramid's 1) once per
    part that has frames at the level it writes, none for an empty one."""
    plan = seqpar.FramePlan.of(frames, net.num_resolutions, k)
    full = [sum(w > 0 for w in plan.widths(frames >> lv)) for lv in range(net.num_resolutions)]
    return 3 * (sum(full[1:]) + sum(full[:-1]))


def sharded_forwards(what: str, net, x, t, ks, per_forward, want, gen, scales=None):
    """`net`'s forward over each group of ks shards on cuda:0 against `want`;
    `per_forward`: K1 launches per shard (every part full at every level),
    or None for `sharded_k1_launches`. Returns ({k: (output, K1 launches, K3
    launches)}, the K1 shapes, the K3 inputs)."""
    out, k1s_all, k3s_all = {}, set(), set()
    frames = x.shape[-2]
    for k in ks:
        sharded = ShardedNCSNpp(net, ["cuda:0"] * k)
        before = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches,
                  seqpar.Sharded.empty_parts)
        with shapes_recorded() as (k1s, k3s), torch.inference_mode():
            got = sharded(x, t)
        torch.cuda.synchronize()
        launched = (kup.upfirdn2d_cuda.launches - before[0],
                    kq.quantize_int8_cuda.launches - before[1])
        empty = seqpar.Sharded.empty_parts - before[2]
        expected = (per_forward * k if per_forward is not None
                    else sharded_k1_launches(net, frames, k))
        check(launched[0] == expected,
              f"{what}: {k} shards launched K1 {launched[0]} times, expected {expected}")
        check(scales is None or launched[1] == len(scales) * k,
              f"{what}: {k} shards launched K3 {launched[1]} times, expected "
              f"{len(scales or {})} x {k}")
        out[k] = (got, *launched)
        k1s_all |= k1s
        k3s_all |= k3s
        plan = seqpar.FramePlan.of(frames, net.num_resolutions, k)
        print(f"  {what}, {k} shards of {plan.widths(frames)} frames (deepest level "
              f"{plan.widths(frames >> (net.num_resolutions - 1))}): max|sharded - unsharded| "
              f"{rel_err(got, want):.3e} of the output's scale; K1 {launched[0]} a call "
              f"(expected {expected}), empty parts that launched nothing {empty}"
              + (f", K3 {launched[1]}" if scales else ""), flush=True)
    return out, k1s_all, k3s_all


def sharded_past_the_coarsest(workdir: str, gen: torch.Generator, shapes):
    """Phase 72's groups of more shards than ncsnpplarge's coarsest level
    holds frames (SP_DEEP), f32 against unsharded and bf16 against f32, and
    `--seq_parallel SP_CLI_SHARDS` through the CLI on a 1 s file with phase
    61's StoRM (an ncsnpplarge score net) against the same CLI unsharded.
    Adds the K1 shapes to `shapes`; returns ({path: K1 launches} f32, bf16)."""
    k1, k1_bf16 = {}, {}
    nets = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", BF16)):
        net = backbones.get_by_name("ncsnpplarge")(input_channels=6, dtype=dtype)
        reset_parameters(net, torch.Generator().manual_seed(0))
        nets[name] = net.cuda().eval()
    t = torch.full((1,), 0.5, device="cuda")
    for frames in sorted({T for T, _ in SP_DEEP}):
        ks = [k for T, k in SP_DEEP if T == frames]
        x = 0.5 * torch.randn(1, 3, FREQS, frames, 2, device="cuda", generator=gen)
        with torch.inference_mode():
            ref = nets["float32"](x, t)
        for name, net in nets.items():
            with torch.inference_mode(), cast_params(net, net.dtype):
                want = net(x, t)
                got, k1s, _ = sharded_forwards(
                    f"ncsnpplarge at {frames} frames ({frames // 64} at its coarsest level), "
                    f"{name}", net, x, t, ks, None, want, gen)
            shapes[name] |= k1s
            (k1 if name == "float32" else k1_bf16)[f"sp_forward_ncsnpplarge_{frames}_{name}"] = \
                sum(v[1] for v in got.values())
            if frames == 128:  # the sharded call's time at the 128-frame bucket, eager
                sharded = ShardedNCSNpp(net, ["cuda:0"] * SP_CLI_SHARDS)
                with torch.inference_mode(), cast_params(net, net.dtype):
                    ms = (time_ms(lambda: net(x, t), reps=2, repeats=3),
                          time_ms(lambda: sharded(x, t), reps=2, repeats=3))
                print(f"  ncsnpplarge {name} forward at {frames} frames: unsharded {ms[0]:.3f} "
                      f"ms, {SP_CLI_SHARDS} shards on the one card {ms[1]:.3f} ms "
                      f"({ms[1] / ms[0]:.2f}x; eager, event-timed)", flush=True)
            if name == "float32":
                check(all(rel_err(v[0], want) <= SP_F32_FORWARD_RTOL for v in got.values()),
                      f"a sharded f32 ncsnpplarge forward at {frames} frames parts from unsharded")
            else:
                unsharded = rel_err(want, ref)
                worst = max(rel_err(v[0], ref) for v in got.values())
                print(f"  bf16 against f32 unsharded: unsharded {unsharded:.3e}, sharded "
                      f"{worst:.3e} ({worst / unsharded:.2f}x, held at {SP_BF16_RATIO}x)",
                      flush=True)
                check(worst <= SP_BF16_RATIO * unsharded,
                      f"a sharded bf16 ncsnpplarge forward at {frames} frames parts from f32")
    del nets
    torch.cuda.empty_cache()

    ckpt, one = os.path.join(workdir, "storm_large.pt"), os.path.join(workdir, "noisy_sp_1s")
    name = f"utt0_{SECONDS[0]:.1f}s.wav"
    os.makedirs(one, exist_ok=True)
    shutil.copy(os.path.join(workdir, "noisy", name), one)
    frames = padded_frames(SECONDS[0])
    denoiser, score = large_structure()
    nfe = 1 + 2 * SP_N
    want_k1 = (sharded_k1_launches(denoiser, frames, SP_CLI_SHARDS)
               + 2 * SP_N * sharded_k1_launches(score, frames, SP_CLI_SHARDS))
    outs, calls = {}, {}
    for tag, extra in (("unsharded", ()), ("seq_parallel", ("--seq_parallel",
                                                             str(SP_CLI_SHARDS)))):
        outs[tag] = {}
        before = (kup.upfirdn2d_cuda.launches, seqpar.Sharded.empty_parts)
        with mock.patch.object(inference, "serving_devices",
                               lambda device, devices=None: [torch.device("cuda:0")]
                               * SP_CLI_SHARDS), shapes_recorded() as (k1s, _), \
                calls_counted() as per_call:
            text = run_enhancement(["--test_dir", one, "--enhanced_dir",
                                    os.path.join(workdir, f"enhanced_large_{tag}"), "--ckpt",
                                    ckpt, "--mode", "storm", "--N", str(SP_N), "--timeit",
                                    "--device", "cuda", *extra], outs[tag])
        calls[tag] = (per_call, kup.upfirdn2d_cuda.launches - before[0],
                      seqpar.Sharded.empty_parts - before[1], rtf_of(text)[name])
        shapes["float32"] |= k1s
    check(calls["unsharded"][0] == [(K1_PER_FORWARD + LARGE_PER_FORWARD * 2 * SP_N, 0, nfe)]
          and calls["seq_parallel"][0] == [(want_k1, 0, nfe)],
          f"(K1, K3, NFE) per call: unsharded {calls['unsharded'][0]}, sharded "
          f"{calls['seq_parallel'][0]} (expected K1 {want_k1})")
    k1["enhancement_ncsnpplarge_seq_parallel_float32"] = calls["seq_parallel"][1]
    err = rel_err(outs["seq_parallel"][name], outs["unsharded"][name])
    print(f"  --seq_parallel {SP_CLI_SHARDS} through the CLI, StoRM with an ncsnpplarge score "
          f"net on a {SECONDS[0]:.0f} s file ({frames} frames; the score net's coarsest level "
          f"{frames >> 6}; N={SP_N} + ald): K1 {calls['seq_parallel'][1]} a call against "
          f"{calls['unsharded'][1]} unsharded, empty parts that launched nothing "
          f"{calls['seq_parallel'][2]}; RTF (a shape's first call: eager) "
          f"{calls['seq_parallel'][3]:.4f} against {calls['unsharded'][3]:.4f} unsharded; "
          f"against the same CLI unsharded {err:.3e} of the output's scale (held at "
          f"{SP_F32_ENHANCE_RTOL})", flush=True)
    check(err <= SP_F32_ENHANCE_RTOL, f"--seq_parallel {SP_CLI_SHARDS} parts from unsharded")
    # a group on one card with empty parts is captured and replayed as any call is
    model = build_model(LARGE_STORM, device="cuda", seed=0)  # the checkpoint's weights
    y = load_wav(os.path.join(one, name))[0][0]
    with shapes_recorded() as (k1s, _):
        row, enhancer, _ = graph_against_eager(
            f"storm ncsnpplarge seq_parallel={SP_CLI_SHARDS} pc N={SP_N} f32, "
            f"{SECONDS[0]:.0f} s", model, y, y.shape[-1] / SR, [], N=SP_N, corrector="ald",
            seq_parallel=SP_CLI_SHARDS, devices=["cuda:0"] * SP_CLI_SHARDS)
    check(enhancer.execution == "graph" and row["k1"] == 3 * want_k1,
          f"the ncsnpplarge group's program: {enhancer.execution}, K1 {row['k1']} in three "
          f"calls (expected 3 x {want_k1})")
    k1["sp_enhancement_ncsnpplarge_float32"] = row["k1"]
    shapes["float32"] |= k1s
    del model, enhancer
    torch.cuda.empty_cache()
    return k1, k1_bf16


def phase_seq_parallel(workdir: str, lengths, gen: torch.Generator):
    """Phase 72. Returns ({path: K1 launches} f32, bf16, {path: K3
    launches} int8 + bf16, {path: stride-1 K1 launches} f32, the errors of
    K1 f32, bf16, K3, stride-1 K1 against plain)."""
    k1, k1_bf16, k3, s1 = {}, {}, {}, {}
    # --data_parallel through the CLI on the one card: --batch 8, bit for bit
    ckpt, noisy = os.path.join(workdir, "storm.pt"), os.path.join(workdir, "noisy")
    outs = {}
    for tag, extra in (("batch8", ("--batch", "8")), ("data_parallel", ("--data_parallel",))):
        outs[tag] = {}
        kup.upfirdn2d_cuda.launches = 0
        with calls_counted() as per_call:
            text = run_enhancement(["--test_dir", noisy, "--enhanced_dir",
                                    os.path.join(workdir, f"enhanced_{tag}"), "--ckpt", ckpt,
                                    "--mode", "storm", "--N", str(SP_N), "--device", "cuda",
                                    *extra], outs[tag])
        nfe = 1 + 2 * SP_N
        check(per_call == [(K1_PER_FORWARD * nfe, 0, nfe)] * len(lengths),
              f"{tag}: (K1, K3, NFE) per call {per_call}")
        k1[f"enhancement_{tag}_float32"] = kup.upfirdn2d_cuda.launches
    diff = max(float(np.abs(outs["data_parallel"][f] - outs["batch8"][f]).max()) for f in lengths)
    print(f"  --data_parallel on the one card (minibatch 8, one replica) against --batch 8 on "
          f"phase 5's {len(lengths)} files (N={SP_N} + ald): max|diff| {diff:.3e}", flush=True)
    check(diff == 0.0, f"--data_parallel parts from --batch 8 by {diff:.3e}")

    models = {"float32": build_model(STORM_CONFIG, device="cuda", seed=0),
              "bfloat16": build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda",
                                      seed=0)}
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    shapes = {"float32": set(), "bfloat16": set()}
    with torch.inference_mode():
        ref = models["float32"].score_net(x, t)
    # one full-width score forward over 2 and 4 shards, f32 and bf16
    fwd_bf16_dist = None
    for name, model in models.items():
        net = model.score_net
        with torch.inference_mode(), cast_params(net, net.dtype):
            want = net(x, t)
            got, k1s, _ = sharded_forwards(f"full-width score net, {name}", net, x, t, SP_KS,
                                           K1_PER_FORWARD, want, gen)
        shapes[name] |= k1s
        (k1 if name == "float32" else k1_bf16)[f"sp_forward_{name}"] = sum(
            v[1] for v in got.values())
        if name == "float32":
            check(all(rel_err(v[0], want) <= SP_F32_FORWARD_RTOL for v in got.values()),
                  "a sharded f32 forward parts from unsharded")
        else:
            fwd_bf16_dist = rel_err(want, ref)
            worst = max(rel_err(v[0], ref) for v in got.values())
            print(f"  bf16 against f32 unsharded: unsharded {fwd_bf16_dist:.3e}, sharded "
                  f"{worst:.3e} ({worst / fwd_bf16_dist:.2f}x, held at {SP_BF16_RATIO}x)",
                  flush=True)
            check(worst <= SP_BF16_RATIO * fwd_bf16_dist, "a sharded bf16 forward parts from f32")

    # int8 + bf16: the scales of one unsharded bf16 forward, K3 on the shards
    net = models["bfloat16"].score_net
    with torch.inference_mode(), cast_params(net, BF16):
        with qconv.stats_collected(net) as stats:
            net(x, t)
        scales = quant_mod.scales_from_stats(stats, net, 128)
        with qconv.scales_attached(net, scales):
            want = net(x, t)
            got, k1s, k3s = sharded_forwards("full-width int8 + bf16 score net", net, x, t,
                                             SP_KS, K1_PER_FORWARD, want, gen, scales=scales)
    shapes["bfloat16"] |= k1s
    k1_bf16["sp_forward_int8_bfloat16"] = sum(v[1] for v in got.values())
    k3["sp_forward_int8_bfloat16"] = sum(v[2] for v in got.values())
    unsharded, worst = rel_err(want, ref), max(rel_err(v[0], ref) for v in got.values())
    print(f"  int8 + bf16 against f32: unsharded {unsharded:.3e}, sharded {worst:.3e}",
          flush=True)
    check(worst <= SP_BF16_RATIO * unsharded, "a sharded int8 + bf16 forward parts from f32")
    k3_err = check_k3_at("the sharded int8 + bf16 forwards", k3s, gen)

    # ncsnpplarge (attention at 16, its deepest level 9 frames: 3, 2, 2, 2 on 4
    # shards) and the DDPM + residual net (the stride-1 instance), f32
    large = backbones.get_by_name("ncsnpplarge")(input_channels=6)  # phase 61's is on the card
    reset_parameters(large, torch.Generator().manual_seed(0))
    large = large.cuda().eval()
    with torch.inference_mode():
        want = large(x, t)
    got, k1s, _ = sharded_forwards("ncsnpplarge, f32", large, x, t, (4,), LARGE_PER_FORWARD,
                                   want, gen)
    check(rel_err(got[4][0], want) <= SP_F32_FORWARD_RTOL, "sharded ncsnpplarge parts")
    k1["sp_forward_ncsnpplarge_float32"] = got[4][1]
    shapes["float32"] |= k1s
    del large
    ddpm = ddpm_net().eval()
    with torch.inference_mode():
        want = ddpm(x, t)
    got, s1s, _ = sharded_forwards("DDPM + residual, f32", ddpm, x, t, SP_KS, S1_PER_FORWARD,
                                   want, gen)
    check(all(rel_err(v[0], want) <= SP_F32_FORWARD_RTOL for v in got.values())
          and {s[0] for s in s1s} <= {"same1", "same2"}, "the sharded DDPM net")
    s1["sp_forward_ddpm_float32"] = sum(v[1] for v in got.values())
    del ddpm
    torch.cuda.empty_cache()
    deep_k1, deep_k1_bf16 = sharded_past_the_coarsest(workdir, gen, shapes)
    k1.update(deep_k1)
    k1_bf16.update(deep_k1_bf16)

    # enhance at N=SP_N + ald on the 4 s file: each group's captured program
    # against its eager loop (bit for bit), and against unsharded serving
    y = load_wav(os.path.join(noisy, f"utt2_{SECONDS[2]:.1f}s.wav"))[0][0]
    enh_f32 = None
    for name, model in models.items():
        want, _ = BucketedEnhancer(model, N=SP_N, corrector="ald", graphs=False)(y, cuda_gen(1))
        enh_f32 = want if name == "float32" else enh_f32
        for k in SP_KS:
            before = kup.upfirdn2d_cuda.launches
            with shapes_recorded() as (k1s, _):
                row, enhancer, got = graph_against_eager(
                    f"storm seq_parallel={k} pc N={SP_N} {name}, 4 s", model, y,
                    y.shape[-1] / SR, [], N=SP_N, corrector="ald", seq_parallel=k,
                    devices=["cuda:0"] * k)
            check(enhancer.execution == "graph" and enhancer.minibatch == 1,
                  f"seq_parallel={k}: {enhancer.execution}, minibatch {enhancer.minibatch}")
            n = kup.upfirdn2d_cuda.launches - before
            check(n == 3 * K1_PER_FORWARD * k * (1 + 2 * SP_N),
                  f"seq_parallel={k} {name}: K1 launched {n} in three calls")
            (k1 if name == "float32" else k1_bf16)[f"sp_enhancement_{k}_{name}"] = n
            shapes[name] |= k1s
            err = rel_err(got, want)
            if name == "float32":
                print(f"    against unsharded: {err:.3e} of the output's scale (held at "
                      f"{SP_F32_ENHANCE_RTOL})", flush=True)
                check(err <= SP_F32_ENHANCE_RTOL, f"seq_parallel={k} f32 enhancement parts")
            else:
                unsharded, sharded = rel_err(want, enh_f32), rel_err(got, enh_f32)
                print(f"    against f32 unsharded: bf16 unsharded {unsharded:.3e}, sharded "
                      f"{sharded:.3e} ({sharded / unsharded:.2f}x, held at {SP_BF16_RATIO}x)",
                      flush=True)
                check(sharded <= SP_BF16_RATIO * unsharded,
                      f"seq_parallel={k} bf16 enhancement parts")
    del models
    torch.cuda.empty_cache()
    err = check_k1_at("the sharded f32 forwards and enhancements", shapes["float32"], gen)
    err_bf16 = check_k1_at("the sharded bf16 forwards and enhancements", shapes["bfloat16"], gen)
    s1_err = check_k1_at("the sharded DDPM forwards (stride-1 instance)", s1s, gen)
    return k1, k1_bf16, k3, s1, err, err_bf16, k3_err, s1_err


# phase 73: the dataset CLIs on a seeded tree (one split, --dummy: 5 files)
DATA_SPEECH_S = (2.3, 2.5, 2.7, 2.9, 3.1)  # every crop of 256 frames fits
CHIME_TYPES = ("CAF", "PED", "STR", "BUS")
DATA_NAME = re.compile(r"^s\d_\d+(_t60=\d\.\d\d)?(_snr=-?\d+\.\d)?(_down=[248])?\.wav$")


def write_data_tree(root: str) -> None:
    """Speech (<root>/speech/tr/s{i}.wav), wham-style noise per split and
    CHiME-style CH1 recordings of every noise type, seeded."""
    rng = np.random.default_rng(73)
    for d in ("speech/tr", "wham/tr", "chime"):
        os.makedirs(os.path.join(root, d))
    for i, sec in enumerate(DATA_SPEECH_S):
        save_wav(os.path.join(root, "speech", "tr", f"s{i}.wav"), synth_wav(sec, i, rng), SR)
    for i in range(2):
        save_wav(os.path.join(root, "wham", "tr", f"n{i}.wav"),
                 0.3 * rng.standard_normal(4 * SR).astype(np.float32), SR)
    for kind in CHIME_TYPES:
        save_wav(os.path.join(root, "chime", f"r_{kind}.CH1.wav"),
                 0.3 * rng.standard_normal(4 * SR).astype(np.float32), SR)


def check_corpus(directory: str, n: int, tags) -> int:
    """`n` clean and noisy files of the same names (the reference's name
    pattern, every tag in `tags`), each pair of one length; returns the
    shortest file's samples."""
    clean, noisy = (sorted(os.listdir(os.path.join(directory, k))) for k in ("clean", "noisy"))
    check(clean == noisy and len(noisy) == n,
          f"{directory}: {len(clean)} clean and {len(noisy)} noisy files, expected {n} pairs")
    shortest = None
    for name in noisy:
        check(bool(DATA_NAME.match(name)) and all(t in name for t in tags),
              f"{directory}: file name {name} (expected the tags {tags})")
        a, b = (wav_info(os.path.join(directory, k, name)) for k in ("clean", "noisy"))
        check(a == b and a[:2] == (SR, 1), f"{directory}/{name}: clean {a} against noisy {b}")
        shortest = a[2] if shortest is None else min(shortest, a[2])
    return shortest


def phase_create_data(workdir: str, gen: torch.Generator):
    """Phase 73. Returns ({path: K1 launches}, {path: K1-bwd launches}, the
    K1 and its adjoint's errors against plain)."""
    root = os.path.join(workdir, "data")
    write_data_tree(root)
    out = os.path.join(root, "corpora")
    speech = ["--speech", "dir", "--speech_dir", os.path.join(root, "speech"), "--splits", "tr",
              "--dummy", "--root", out]
    t0 = time.perf_counter()
    # the user's line, in a process of its own, then the other CLIs in this one
    proc = subprocess.run([sys.executable, "-m", "storm_tpu_torch.preprocessing.create_data",
                           "--task", "derev+enh", "--noise", "wham", "--noise_dir",
                           os.path.join(root, "wham", "{split}"), "--corruption-per-sample",
                           "2", *speech], capture_output=True, text=True, timeout=300)
    print("".join(f"    | {line}\n" for line in proc.stdout.splitlines()), end="", flush=True)
    check(proc.returncode == 0, f"create_data --task derev+enh failed:\n{proc.stderr[-3000:]}")
    derev_s = time.perf_counter() - t0
    captured(create_data.main, ["--task", "bwe", "--bwe-method", "decimate", *speech])
    captured(create_data.main, ["--task", "enh", "--noise", "chime", "--noise_dir",
                                os.path.join(root, "chime"), *speech])
    wind = os.path.join(root, "wind")
    captured(simulate_wind_noise.main, ["--dir", wind, "--n", "2"])
    captured(nonlinear_mixing.main, ["--speech_dir", os.path.join(root, "speech", "{}"),
                                     "--noise_dir", wind, "--root", out, "--dummy"])
    wall = time.perf_counter() - t0
    files = len(DATA_SPEECH_S)
    corpus = os.path.join(out, "dir_derev+enh")
    shortest = check_corpus(os.path.join(corpus, "audio", "tr"), 2 * files, ("_t60=", "_snr="))
    check_corpus(os.path.join(out, "dir_bwe", "audio", "tr"), files, ("_down=",))
    check_corpus(os.path.join(out, "dir_enh_chime", "audio", "tr"), files, ("_snr=",))
    winds = sorted(os.listdir(wind))
    check(winds == ["simulated_0.wav", "simulated_1.wav"]
          and all(wav_info(os.path.join(wind, w)) == (SR, 1, 8 * SR) for w in winds),
          f"wind noise: {winds}")
    mixed = os.path.join(out, "speech_in_noise_nonlinear", "tr")
    for i, name in enumerate(sorted(os.listdir(os.path.join(mixed, "clean")))):
        (noisy,) = [f for f in os.listdir(os.path.join(mixed, "noisy"))
                    if f.startswith(f"{name[:-4]}_{i}_snr=")]
        check(wav_info(os.path.join(mixed, "clean", name))
              == wav_info(os.path.join(mixed, "noisy", noisy)), f"nonlinear mix {noisy}")
    for d in ("dir_derev+enh", "dir_bwe", "dir_enh_chime", "speech_in_noise_nonlinear"):
        check(os.path.isfile(os.path.join(out, d, "log_stats.txt")), f"{d}: no log_stats.txt")
    print(f"  corpora written in {wall:.2f} s ({derev_s:.2f} s for derev+enh in its own "
          f"process): derev+enh {2 * files} pairs (the shortest {shortest / SR:.3f} s), bwe "
          f"(decimate) {files}, enh (CHiME-style noise) {files}, 2 wind noise files of 8 s, "
          f"{files} nonlinear mixtures; names and pair lengths checked", flush=True)

    # one batch of the derev+enh corpus through the port's loader, one
    # full-width StoRM step on it (forward, backward, Adam, EMA)
    dm = SpecsDataModule(base_dir=corpus, format="timit", batch_size=TRAIN_B, num_workers=4)
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))
    target = (TRAIN_FRAMES - 1) * HOP
    check(batch[0].shape == batch[1].shape == (TRAIN_B, target),
          f"loader batch {batch[0].shape}, expected ({TRAIN_B}, {target})")
    model = build_model(STORM_CONFIG, device="cuda", seed=0).train()
    programs = train_graphs.TrainPrograms(init_train_state(model, model.lr), graphs=False)
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    with shapes_recorded() as (k1s, _), adjoint_shapes_recorded() as bwds:
        aux, ms = timed_event(lambda: programs.step(batch, cuda_gen(73)))
    launched = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
    want = step_launches("regen-joint-training")
    loss = float(aux["loss"])
    print(f"  one B={TRAIN_B} step on the created corpus (SpecsDataModule, format timit): loss "
          f"{loss:.4f}, {ms:.2f} ms (eager, the first step); K1 launches {launched}, expected "
          f"{want} from the module list", flush=True)
    check(math.isfinite(loss) and launched == want,
          f"the step on the created corpus: loss {loss}, launches {launched}")
    del programs, model
    torch.cuda.empty_cache()
    err = check_k1_at("the step on the created corpus", k1s, gen)
    bwd_err = check_k1_bwd_at("the step on the created corpus", bwds, gen)
    return ({"train_created_corpus_float32": launched[0]},
            {"train_created_corpus_float32": launched[1]}, err, bwd_err)


# phase 74: stream_quality at full width, bf16: one 64 s file whole and streamed
SQ_DUR_S, SQ_N, SQ_CHUNK_S, SQ_OVERLAP_S, SQ_BATCH = 64.0, 3, 4.0, 0.5, 8
SQ_FRAMES = padded_frames(SQ_DUR_S)


def stream_calls(seconds: float, chunk_s: float, overlap_s: float, batch: int) -> int:
    """The enhancer calls of `utils/streaming.stream_enhance` on a file."""
    T, chunk, overlap = int(seconds * SR), -(-int(chunk_s * SR) // BUCKET) * BUCKET, int(
        overlap_s * SR)
    return -(-len(range(0, T - overlap, chunk - overlap)) // batch)


def widest_call_ms(what: str, x: torch.Tensor, kernel, plain, library, bounds) -> dict:
    """Event-timed kernel, plain and library times of one call beside its
    bound (the larger of bytes and operations)."""
    row = dict(shape=list(x.shape), dtype=str(x.dtype).split(".")[-1], ms=time_ms(kernel),
               plain_ms=time_ms(plain, reps=3, repeats=3),
               library_ms=time_ms(library, reps=5, repeats=3) if library else None,
               bound_ms=max(bounds), bound_by="bytes" if bounds[0] >= bounds[1] else "operations")
    print(f"  {what} {tuple(x.shape)} {row['dtype']}: ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} library_ms="
          + ("-" if library is None else f"{row['library_ms']:.4f}")
          + f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) ms/bound="
          f"{row['ms'] / row['bound_ms']:.2f}", flush=True)
    return row


def phase_stream_quality(workdir: str, gen: torch.Generator):
    """Phase 74. Returns ({path: K1 launches} bf16, {path: K3 launches}, the
    K1-bf16 and K3 errors against plain, the widest calls' times)."""
    calls, streamed = [], []

    class Timed(BucketedEnhancer):
        """The script's enhancer, each call timed (its numpy result is
        synced) with its launches and, at minibatch 1, its peak memory."""

        def __call__(self, y, generator=None, noise=None):
            torch.cuda.synchronize()
            if self.minibatch == 1:
                torch.cuda.reset_peak_memory_stats()
            before, t0 = kup.upfirdn2d_cuda.launches, time.perf_counter()
            out = super().__call__(y, generator, noise)
            calls.append(dict(minibatch=self.minibatch, s=time.perf_counter() - t0,
                              k1=kup.upfirdn2d_cuda.launches - before,
                              peak=torch.cuda.max_memory_allocated() / 2**30))
            return out

    real_stream = stream_quality.stream_enhance

    def timed_stream(*args, **kw):
        t0 = time.perf_counter()
        out = real_stream(*args, **kw)
        streamed.append(time.perf_counter() - t0)
        return out

    argv = ["--ckpt", os.path.join(workdir, "storm.pt"), "--dur_s", str(SQ_DUR_S), "--n_files",
            "1", "--N", str(SQ_N), "--chunk_s", str(SQ_CHUNK_S), "--overlap_s",
            str(SQ_OVERLAP_S), "--batch", str(SQ_BATCH), "--dtype", "bfloat16", "--json",
            os.path.join(workdir, "stream_quality.json")]
    kup.upfirdn2d_cuda.launches = 0
    with shapes_recorded() as (k1s, _), \
            mock.patch.object(stream_quality, "BucketedEnhancer", Timed), \
            mock.patch.object(stream_quality, "stream_enhance", timed_stream):
        out, _ = captured(stream_quality.main, argv)
    per_call = K1_PER_FORWARD * (1 + SQ_N)  # the denoiser and N score forwards
    whole = [c for c in calls if c["minibatch"] == 1]
    chunked = [c for c in calls if c["minibatch"] == SQ_BATCH]
    n_stream = stream_calls(SQ_DUR_S, SQ_CHUNK_S, SQ_OVERLAP_S, SQ_BATCH)
    check(len(whole) == 1 and len(chunked) == n_stream and len(streamed) == 1
          and all(c["k1"] == per_call for c in calls),
          f"stream_quality's enhancer calls {calls}: expected one whole, {n_stream} streamed, "
          f"{per_call} K1 launches each")
    check(kup.upfirdn2d_cuda.launches == per_call * (1 + n_stream), "K1 launches")
    check({s[-1] for s in k1s} == {BF16} and any(s[4] == SQ_FRAMES for s in k1s),
          f"K1 shapes {sorted(k1s, key=str)[:4]}")
    s = out["summary"]
    check(all(math.isfinite(v) for v in s["noisy"] + s["whole"] + s["stream"]),
          f"stream_quality SUMMARY not finite: {s}")
    (w,) = whole
    print(f"  {SQ_DUR_S:.0f} s whole at B=1 ({SQ_FRAMES} frames, N={SQ_N}, no corrector, bf16, "
          f"the shape's first call: the eager loop): {w['s']:.3f} s wall, RTF "
          f"{w['s'] / SQ_DUR_S:.4f}, max_memory_allocated {w['peak']:.2f} GiB; streamed "
          f"({n_stream} calls of {SQ_BATCH} chunks of {SQ_CHUNK_S} s, overlap {SQ_OVERLAP_S} s; "
          f"first call eager, second captured, third replayed): {streamed[0]:.3f} s, RTF "
          f"{streamed[0] / SQ_DUR_S:.4f} (calls {[round(c['s'], 3) for c in chunked]} s); K1 "
          f"{per_call} per call, {kup.upfirdn2d_cuda.launches} in all", flush=True)
    k1 = {"stream_quality_whole_64s_bf16": w["k1"],
          "stream_quality_streamed_bf16": sum(c["k1"] for c in chunked)}
    err = check_k1_at("stream_quality (64 s whole, 4 s chunks at B=8)", k1s, gen)
    widest = max(k1s, key=lambda c: c[1] * c[2] * c[3] * c[4])  # by input elements
    cfg, B, C, H, W, _ = widest
    x = torch.randn(B, C, H, W, device="cuda", generator=gen).to(BF16)
    c = CONFIGS[cfg]
    args = dict(up=c["up"], down=c["down"], pad=c["pad"])
    Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
    lib = library_call(cfg, C, dtype=BF16)
    times = {"upfirdn2d_bf16": widest_call_ms(
        f"K1-bf16 {cfg}, the widest call of the 64 s file", x,
        lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args),
        lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), lambda: lib(x),
        bound_ms(x.numel(), B * C * Ho * Wo, 16, 2))}
    del x, lib
    torch.cuda.empty_cache()

    # K3 at the 64 s widths: one int8 + bf16 score forward (scales from a
    # bf16 forward at that width)
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    net = model.score_net
    xin = 0.5 * torch.randn(1, 3, FREQS, SQ_FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode(), cast_params(net, BF16):
        with qconv.stats_collected(net) as stats:
            net(xin, t)
        scales = quant_mod.scales_from_stats(stats, net, QUANT_MIN_CHANNELS)
        kq.quantize_int8_cuda.launches = 0
        with qconv.scales_attached(net, scales), shapes_recorded() as (_, k3s):
            y = net(xin, t)
        torch.cuda.synchronize()
    k3 = kq.quantize_int8_cuda.launches
    check(k3 == len(scales) == N_QUANT and bool(torch.isfinite(y).all()),
          f"the 64 s int8 + bf16 forward: {k3} K3 launches, {len(scales)} scales")
    del model, net, xin, y, stats
    torch.cuda.empty_cache()
    k3_err = check_k3_at(f"one int8 + bf16 score forward at {SQ_FRAMES} frames", k3s, gen)
    shape = max((s[0] for s in k3s), key=math.prod)
    x = (10.0 * torch.randn(shape, device="cuda", generator=gen)).to(BF16)
    times["quantize_int8_bf16_product"] = widest_call_ms(
        "K3 bf16-product, the widest input of the 64 s forward", x,
        lambda: kq.quantize_int8_cuda(x, PROBE_S, BF16),
        lambda: kq.quantize_int8_plain(x, PROBE_S, BF16), None, k3_bound_ms(x))
    del x
    torch.cuda.empty_cache()
    return k1, {"int8_forward_64s_bfloat16": k3}, err, k3_err, times


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one enhancement, two train steps, one int8 "
                             "enhancement, one B=4 enhancement, one bf16 enhancement, two "
                             "bf16 train steps, one dc3 bf16 enhancement and one bench call "
                             "with and without int8 and print the device time by kernel")
    parser.add_argument("--train_worker", default=None, metavar="OUT",
                        help="phase 71's worker: run the training CLI on the flags after '--' "
                             "and write what it measured to OUT (no smoke run)")
    parser.add_argument("train_flags", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on a card only")
    if args.train_worker:
        flags = args.train_flags[1:] if args.train_flags[:1] == ["--"] else args.train_flags
        train_worker(args.train_worker, flags)
        return
    global T_START
    t_start = T_START = time.perf_counter()

    phase_header("== phase 1: device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    resolve_device("cuda")  # TF32 off for float32 matmuls and convolutions
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    phase_header("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    kup._lib(), kq._lib(), kfa._lib()
    print(f"  built {list(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}")

    phase_header("== phase 3: upfirdn2d kernel against plain at the main path's shapes", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape, max_err = phase_kernel_vs_plain(gen)

    phase_header("== phase 4: full-width NCSN++ forward, kernel path against plain path", flush=True)
    phase_full_width_forward(gen)

    with tempfile.TemporaryDirectory() as workdir:  # phase 5's checkpoint and files, for 10-11
        phase_header("== phase 5: main path through storm_tpu_torch.enhancement", flush=True)
        launches, f32_rtf, lengths, f32_outputs = phase_main_path(workdir)

        if args.profile:
            phase_header("== phase 6: where the device time goes", flush=True)
            phase_profile()

        phase_header("== phase 7: upfirdn2d forward and backward kernels against plain at a train "
              "step's shapes", flush=True)
        bwd_shape, bwd_err, train_fwd_err = phase_backward_vs_plain(gen)

        phase_header("== phase 8: training through storm_tpu_torch.train", flush=True)
        phase_train_gradients(gen)
        train_dir = os.path.join(workdir, "train")  # the corpus, for phases 25-26 too
        os.makedirs(train_dir)
        train_f32 = phase_train(train_dir)
        train_launches = train_f32["launches"]

        if args.profile:
            phase_header("== phase 9: where a train step's device time goes", flush=True)
            phase_profile_train()

        phase_header("== phase 10: int8 quantizer kernel against plain at the int8 path's inputs",
              flush=True)
        k3_shape, k3_calls, probe, k3_err = phase_quantizer_vs_plain(workdir, gen)

        phase_header("== phase 11: int8 main path through storm_tpu_torch.enhancement --quant int8",
              flush=True)
        k3_launches = phase_int8_path(workdir, f32_rtf, lengths)

        phase_header("== phase 12: fused_leaky_relu kernel through its op API against plain",
              flush=True)
        k2 = phase_fused_act(gen)

        if args.profile:
            phase_header("== phase 13: where an int8 enhancement's device time goes", flush=True)
            phase_profile_int8(workdir)

        phase_header(f"== phase 14: batched CLI (--batch {CLI_BATCH})", flush=True)
        batch_launches, batch_err, batch_dir, batch_outputs = phase_batched_cli(workdir, gen)

        phase_header("== phase 15: HTTP server with dynamic batching (storm_tpu_torch.serve)",
              flush=True)
        serve_launches, serve_k3, serve_err, serve_k3_err = phase_server(workdir, batch_dir, gen)

        phase_header(f"== phase 16: streaming (--stream_chunk_s {STREAM_CHUNK_S})", flush=True)
        stream_launches, stream_k3, stream_err, stream_k3_err = phase_streaming(workdir, gen)

        if args.profile:
            phase_header(f"== phase 17: where a B={CLI_BATCH} enhancement's device time goes", flush=True)
            phase_profile_batch()

        phase_header("== phase 18: bfloat16 kernels against plain: upfirdn2d at the main path's "
              "shapes and the adjoint at a train step's, GroupNorm, one NCSN++ forward",
              flush=True)
        bf16_shape, bf16_err = phase_bf16_kernels(gen)

        phase_header("== phase 19: bfloat16 CLI (--dtype bfloat16; --batch 4; --quant int8)",
              flush=True)
        bf16_k1, bf16_k3, bf16_k3_shapes, bf16_cli_err, bf16_exact = phase_bf16_cli(
            workdir, f32_outputs, f32_rtf, lengths, batch_dir, batch_outputs, gen)

        phase_header("== phase 20: the quantizer's bfloat16-product mode against plain at the int8 "
              "bf16 path's inputs", flush=True)
        k3b_shape, k3b_calls, k3b_err = phase_bf16_quantizer(workdir)
        k3b_err = max(k3b_err, check_k3_at("the int8 bf16 CLI", bf16_k3_shapes, gen))

        phase_header("== phase 21: HTTP server at its default dtype (bfloat16), then int8 + bf16",
              flush=True)
        bf16_serve_k1, bf16_serve_k3, bf16_serve_err, bf16_serve_k3_err = phase_bf16_server(
            workdir, gen)

        phase_header("== phase 22: streaming in bfloat16", flush=True)
        bf16_stream_k1, bf16_stream_err = phase_bf16_streaming(workdir, gen)

        if args.profile:
            phase_header("== phase 23: where a bfloat16 enhancement's device time goes", flush=True)
            phase_profile_bf16()

        phase_header("== phase 24: bfloat16 training's kernels against plain: upfirdn2d and its "
              "adjoint at a train step's shapes, one full-width bf16 step's gradients",
              flush=True)
        bf16_bwd_shape, bf16_bwd_err = phase_bf16_backward(gen)

        phase_header("== phase 25: bfloat16 training through storm_tpu_torch.train --dtype bfloat16 "
              f"with the in-training evaluation (--num_eval_files {VALID_FILES})", flush=True)
        # three epochs: the third evaluation replays the graph the second captured
        train_bf16 = phase_train(train_dir, "bfloat16", steps_total=3 * (TRAIN_FILES // TRAIN_B),
                                 eval_files=VALID_FILES, eval_n=F32_EVAL_N)
        print(f"  bf16 against f32 (phase 8, this run): step {train_bf16['step_ms']:.2f} ms "
              f"against {train_f32['step_ms']:.2f} ({train_f32['step_ms'] / train_bf16['step_ms']:.2f}x); "
              f"{train_bf16['audio_s_per_s']:.3f} audio s per s against "
              f"{train_f32['audio_s_per_s']:.3f}; peak {train_bf16['peak_gib']:.2f} GiB against "
              f"{train_f32['peak_gib']:.2f}", flush=True)

        phase_header("== phase 26: float32 training with the in-training evaluation "
              f"(--num_eval_files {VALID_FILES} --eval_N {F32_EVAL_N}, one epoch)", flush=True)
        train_f32_eval = phase_train(train_dir, "float32", steps_total=TRAIN_FILES // TRAIN_B,
                                     eval_files=VALID_FILES, eval_n=F32_EVAL_N)

        # the trainer's programs (56-58) beside the other training phases, while
        # the process holds the least memory (a full-width f32 step's pool is
        # 42.5 GiB)
        torch.cuda.empty_cache()
        phase_header("== phase 56: each training program's replay against the eager step, bit for "
                     "bit; its launches from the profiler", flush=True)
        tg_rows = phase_train_graphs(os.path.join(train_f32["ckpt_dir"], "last.pt"), {
            "f32 step": dict(train_f32, phase=8), "bf16 step": dict(train_bf16, phase=25)})

        phase_header("== phase 57: a resume from last.pt through the programs against the "
                     "continuous run", flush=True)
        resume_before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        phase_train_resume(train_dir)
        resume_launched = (kup.upfirdn2d_cuda.launches - resume_before[0],
                           kup.upfirdn2d_bwd_cuda.launches - resume_before[1])

        phase_header("== phase 58: the asynchronous checkpoint against the synchronous one",
                     flush=True)
        phase_async_save(workdir)

        phase_header("== phase 27: fused_leaky_relu in bfloat16 through its op API against plain",
              flush=True)
        k2_bf16 = phase_fused_act_bf16(gen)

        if args.profile:
            phase_header("== phase 28: where a bfloat16 train step's device time goes", flush=True)
            phase_profile_train_bf16()

        phase_header("== phase 29: deep-feature caching: full-width deep and shallow passes against "
              "the forward", flush=True)
        dc_fwd_k1, dc_fwd_k3 = phase_deepcache_forward(workdir, gen)

        phase_header(f"== phase 30: the CLI with --deepcache {DC_K} (float32, bfloat16, int8 + bf16)",
              flush=True)
        dc_cli_k1, dc_cli_k3, dc_cli_err, dc_cli_bf16_err, dc_cli_k3_err = phase_deepcache_cli(
            workdir, lengths, {"float32": (f32_rtf, f32_outputs), **bf16_exact}, gen)

        phase_header(f"== phase 31: the server with --deepcache {DC_K} (bf16, then int8 + bf16), then "
              "serve_load against it", flush=True)
        dc_srv_k1, dc_srv_k3, dc_srv_err, dc_srv_k3_err = phase_deepcache_server(workdir, gen)

        phase_header("== phase 32: python -m storm_tpu_torch.bench at bench.py's defaults, then --train",
              flush=True)
        (bench_k1, bench_k3, bench_bwd, bench_lines, bench_err, bench_k3_err,
         bench_bwd_err) = phase_bench(workdir, gen)

        if args.profile:
            phase_header("== phase 33: where a dc3 bfloat16 enhancement's device time goes", flush=True)
            phase_profile_dc3_bf16()
            phase_header("== phase 34: where a bench call's device time goes (B=16, with and without "
                  "int8)", flush=True)
            phase_profile_bench()

        phase_header(f"== phase 35: the ODE CLI (--sampler ode: {ODE_METHOD}, N={N_STEPS}) in float32, "
              "bf16 and int8 + bf16", flush=True)
        ode_k1, ode_k3, ode_err, ode_bf16_err, ode_k3_err = phase_ode_cli(
            workdir, lengths, {"float32": (f32_rtf, f32_outputs), **bf16_exact}, gen)

        phase_header(f"== phase 36: every sampler at the 4 s bucket in bf16, N={METHODS_N}",
                     flush=True)
        methods_k1, methods_err = phase_ode_methods(workdir, gen)

        phase_header(f"== phase 37: the server with --sampler ode (bf16, then --deepcache {DC_K})",
              flush=True)
        ode_srv_k1, ode_srv_err = phase_ode_server(workdir, gen)

        phase_header(f"== phase 38: streaming with --sampler ode --N {ODE_N}", flush=True)
        ode_stream_k1, ode_stream_err = phase_ode_streaming(workdir, gen)

        phase_header("== phase 39: python -m storm_tpu_torch.evaluate (pc, then --sampler ode)",
              flush=True)
        eval_k1 = phase_evaluate(workdir)

        phase_header("== phase 40: training the score-only and denoiser-only models and OUVP StoRM "
              "at full width", flush=True)
        (new_train, nt_f32_err, nt_bf16_err, nt_bwd_err,
         nt_bwd_bf16_err) = phase_train_new_modes(train_dir, gen, train_f32, train_bf16)
        ckpts = {"score-only": new_train["score-only"]["ckpt_dir"],
                 "denoiser-only": new_train["denoiser-only_sisdr"]["ckpt_dir"],
                 "ouvp": new_train["storm_ouvp_bf16"]["ckpt_dir"]}
        ckpts = {k: os.path.join(v, "last.pt") for k, v in ckpts.items()}

        phase_header("== phase 41: the CLI with the score-only and denoiser-only checkpoints (float32, "
              "bf16, int8 + bf16)", flush=True)
        nm_k1, nm_k3, nm_err, nm_bf16_err, nm_k3_err = phase_new_modes_cli(
            workdir, ckpts, lengths, {"float32": (f32_rtf, f32_outputs), **bf16_exact}, gen)

        phase_header("== phase 42: OUVP StoRM serving (pc, ode heun; etd2 refused)", flush=True)
        ouvp_k1, ouvp_err = phase_ouvp_serving(workdir, ckpts["ouvp"], lengths, bf16_exact, gen)

        phase_header("== phase 43: the server with --mode score-only (and --deepcache 3) and "
              "denoiser-only; denoiser-only streaming", flush=True)
        nm_srv_k1, nm_stream_err, nm_srv_err = phase_new_modes_server(workdir, gen)

        phase_header("== phase 44: python -m storm_tpu_torch.evaluate --mode score-only and "
              "denoiser-only", flush=True)
        nm_eval_k1 = phase_new_modes_evaluate(workdir)

        phase_header(f"== phase 45: one full-width f32 distill step ({DISTILL_METHOD} N={DISTILL_N} "
              "targets) through the kernels against the plain path", flush=True)
        d_step, d_step_ms, d_step_peak, d_grad_err = phase_distill_step(
            os.path.join(train_f32["ckpt_dir"], "last.pt"), gen)

        phase_header("== phase 46: python -m storm_tpu_torch.train --mode distill --teacher_ckpt "
              f"(phase 25's bf16 checkpoint; --num_eval_files {DISTILL_EVAL_FILES})", flush=True)
        d_train = phase_distill_train(train_dir, os.path.join(train_bf16["ckpt_dir"], "last.pt"),
                                      train_bf16)

        phase_header("== phase 47: the CLI with --mode distill (float32, bf16, int8 + bf16)", flush=True)
        d_k1, d_k3, d_err, d_bf16_err, d_k3_err, d_rtf = phase_distill_cli(
            workdir, os.path.join(d_train["ckpt_dir"], "last.pt"), lengths,
            {"float32": (f32_rtf, f32_outputs), **bf16_exact}, gen)

        phase_header(f"== phase 48: --mode distill with --batch {CLI_BATCH}, streaming and the server",
              flush=True)
        d_srv_k1, d_srv_err = phase_distill_serving(workdir, gen)

        phase_header("== phase 49: python -m storm_tpu_torch.evaluate --mode distill", flush=True)
        d_eval_k1 = phase_distill_evaluate(workdir)

        phase_header("== phase 50: python -m storm_tpu_torch.bench --distill", flush=True)
        d_bench_k1, d_bench_k3, d_bench_line, d_bench_err, d_bench_k3_err = phase_distill_bench(
            gen)

        phase_header(f"== phase 51: upfirdn2d and its adjoint at nf={NF32} (the quality run's "
                     "width)", flush=True)
        nf32_f32_err, nf32_bf16_err, nf32_bwd_err, nf32_bwd_bf16_err = phase_k1_nf32(gen)

        phase_header("== phase 52: each serving path's captured CUDA graph against the eager loop, "
                     "bit for bit", flush=True)
        g_models, g_rows = graph_models(workdir), []
        g_before = (kup.upfirdn2d_cuda.launches, kq.quantize_int8_cuda.launches)
        g_enhancers = phase_graph_equals_eager(workdir, g_models, g_rows)

        phase_header("== phase 53: K1 and K3 launches in a replay, from the profiler", flush=True)
        g_busy = phase_graph_launches(workdir, g_models, g_enhancers)

        phase_header("== phase 54: what the graph does to the time (RTF graph against eager, busy "
                     "share, capture s, pool bytes)", flush=True)
        phase_graph_time(workdir, g_models, g_rows, g_busy)
        g_k1 = kup.upfirdn2d_cuda.launches - g_before[0]
        g_k3 = kq.quantize_int8_cuda.launches - g_before[1]
        g_k1_f32 = sum(r["k1"] for r in g_rows if r["f32"])
        del g_models, g_enhancers
        torch.cuda.empty_cache()

        phase_header("== phase 55: the server's warmed graphs, streaming's replay, the bench line",
                     flush=True)
        g_srv_k1, g_srv_err = phase_graph_serving(workdir, bench_lines["bench_serving"], gen)

        torch.cuda.empty_cache()
        phase_header("== phase 59: a full-width DDPM + residual NCSN++ (the stride-1 instance) "
                     "through the kernels against plain; its denoiser through the CLI", flush=True)
        s1_fwd, s1_bwd, s1_launched = phase_ddpm(workdir, lengths, gen)

        phase_header("== phase 60: the stride-1 instance and its adjoint against plain at the "
                     "DDPM net's shapes, timed", flush=True)
        s1_rows = phase_stride1_kernel(s1_fwd, s1_bwd, gen)

        phase_header("== phase 61: ncsnpplarge: its forwards at 192 and 576 frames, StoRM with it "
                     "through the CLI and its captured program", flush=True)
        large_k1, large_err, large_bf16_err = phase_ncsnpplarge(workdir, lengths, gen)

        phase_header("== phase 62: python -m storm_tpu_torch.train --backbone_score ncsnpplarge "
                     "--dtype bfloat16; one f32 step's memory", flush=True)
        large_train, large_f32 = phase_ncsnpplarge_train(train_dir, gen)

        phase_header("== phase 63: python -m storm_tpu_torch.train --mode denoiser-only "
                     "--backbone_denoiser convtasnet --return_time", flush=True)
        ctn_train = phase_convtasnet_train(train_dir)

        phase_header("== phase 64: StoRM with ConvTasNet and ae-ncsnpp denoisers through the CLI; "
                     "the ConvTasNet StoRM server", flush=True)
        td_k1, td_k1_bf16, td_err, td_bf16_err = phase_time_domain_storm(workdir, lengths, gen)

        phase_header("== phase 65: GaGNet at the reference CLI's width: forwards at 1, 2.5 and 4 "
                     "s in f32 and bf16, its captured replay", flush=True)
        phase_gagnet(gen)

        phase_header("== phase 66: StoRM with a GaGNet denoiser through the CLI (f32, bf16, int8 "
                     f"+ bf16), its program at N={GRAPH_N} + ald, the server", flush=True)
        gs_k1, gs_k1_bf16, gs_k3, gs_err, gs_bf16_err, gs_k3_err, _ = phase_gagnet_storm(
            workdir, lengths, gen)

        phase_header("== phase 67: python -m storm_tpu_torch.train with GaGNet (StoRM bf16; "
                     "denoiser-only f32, IN and BN)", flush=True)
        gag_train = phase_gagnet_train(train_dir)

        phase_header("== phase 68: a reference Lightning GaGNet-BN checkpoint through python -m "
                     "storm_tpu_torch.compat.convert, the CLI with its side file, evaluate",
                     flush=True)
        phase_gagnet_bn_checkpoint(workdir, lengths)

        phase_header(f"== phase 69: multichannel input (D={D2}) through the CLI (f32, bf16, int8 "
                     f"+ bf16; --batch {CLI_BATCH}; streaming), the server, and its program at "
                     f"N={GRAPH_N} + ald", flush=True)
        (d2_k1, d2_k1_bf16, d2_k3, d2_err, d2_bf16_err,
         d2_k3_err) = phase_d2_serving(workdir, g_rows, gen)

        phase_header(f"== phase 70: python -m storm_tpu_torch.train --spatial_channels {D2} "
                     "--dtype bfloat16; its checkpoint served", flush=True)
        d2_train, d2_train_err, d2_bwd_err = phase_d2_train(workdir, train_bf16, gen)

        phase_header(f"== phase 71: data-parallel training, {DP_PROCESSES} processes on one card "
                     "(gloo), against one process at the same global batch: StoRM, and "
                     "GaGNet-BN with its moments across the processes", flush=True)
        dp_k1, dp_bwd, dp_err, dp_bwd_err = phase_data_parallel(workdir, gen)

        phase_header(f"== phase 72: serving across devices on one card: --data_parallel through "
                     f"the CLI; seq_parallel {SP_KS} with every shard on cuda:0 (forwards, int8 "
                     f"+ bf16, ncsnpplarge, DDPM; ncsnpplarge over more shards than its "
                     f"coarsest level's frames, {SP_DEEP}, and through the CLI; enhance at "
                     f"N={SP_N} + ald, graph and eager)",
                     flush=True)
        (sp_k1, sp_k1_bf16, sp_k3, sp_s1, sp_err, sp_bf16_err, sp_k3_err,
         sp_s1_err) = phase_seq_parallel(workdir, lengths, gen)

        phase_header("== phase 73: the dataset CLIs on a seeded tree (create_data derev+enh, "
                     "bwe, enh; simulate_wind_noise; nonlinear_mixing), one full-width step on "
                     "the derev+enh corpus", flush=True)
        cd_k1, cd_bwd, cd_err, cd_bwd_err = phase_create_data(workdir, gen)

        phase_header(f"== phase 74: stream_quality at full width in bf16: a {SQ_DUR_S:.0f} s "
                     f"file whole and in {SQ_CHUNK_S} s chunks (N={SQ_N}); K3 at the "
                     f"{SQ_DUR_S:.0f} s widths", flush=True)
        sq_k1, sq_k3, sq_err, sq_k3_err, sq_widest = phase_stream_quality(workdir, gen)

    def entry(name, source, replaces, per_shape_ms, calls, err, launches, work, **extra):
        keys = ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")
        total = {k: sum(per_shape_ms[c][k] for c in calls) if k in per_shape_ms[calls[0]]
                 else None for k in keys}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": total["ms"], "device_ms": total["device_ms"], "plain_ms": total["plain_ms"],
                "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
                "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
                "library_ms": total["library_ms"], "work": work, **extra}

    k1_by_path = {"enhancement": launches, "train": train_launches[0],
                  "train_with_evaluation": train_f32_eval["launches"][0],
                  "batched_cli": batch_launches, **serve_launches, **stream_launches}
    k3_by_path = {"enhancement_int8": k3_launches, "server_int8": serve_k3,
                  "streaming_int8": stream_k3}
    k1_bf16_by_path = {**bf16_k1, **bf16_serve_k1, "streaming_bf16": bf16_stream_k1,
                       "train_bf16": train_bf16["launches"][0]}
    k3_bf16_by_path = {"enhancement_int8_bf16": bf16_k3, "server_int8_bf16": bf16_serve_k3}
    # the deepcache paths and the bench (phases 29-32), by the dtype they ran in
    dc_k1 = {**dc_fwd_k1, **dc_cli_k1, **dc_srv_k1, **bench_k1}
    dc_k3 = {k: v for k, v in {**dc_fwd_k3, **dc_cli_k3, **dc_srv_k3, **bench_k3}.items() if v}
    for by_path, launched in ((k1_by_path, dc_k1), (k3_by_path, dc_k3)):
        by_path.update({k: v for k, v in launched.items() if "float32" in k})
    for by_path, launched in ((k1_bf16_by_path, dc_k1), (k3_bf16_by_path, dc_k3)):
        by_path.update({k: v for k, v in launched.items() if "float32" not in k})
    dc_k1_bf16_err = max(dc_cli_bf16_err, dc_srv_err, bench_err)
    dc_k3_err = max(dc_cli_k3_err, dc_srv_k3_err, bench_k3_err)
    # the probability-flow samplers and the evaluation (phases 35-39)
    k1_by_path.update({"enhancement_ode_float32": ode_k1["enhancement_ode_float32"],
                       "streaming_ode": ode_stream_k1, **eval_k1})
    k1_bf16_by_path.update({k: v for k, v in ode_k1.items() if "float32" not in k})
    k1_bf16_by_path.update({**methods_k1, **ode_srv_k1})
    k3_bf16_by_path["enhancement_ode_int8_bfloat16"] = ode_k3["enhancement_ode_int8_bfloat16"]
    ode_k1_err = max(ode_err, ode_stream_err)
    ode_k1_bf16_err = max(ode_bf16_err, methods_err, ode_srv_err)
    # the score-only and denoiser-only models and OUVP StoRM (phases 40-44)
    nm_runs = {f"train_{name}": r for name, r in new_train.items()}

    def is_bf16(path):
        return "bf16" in path or "bfloat16" in path

    nm_paths = {**{p: r["launches"][0] for p, r in nm_runs.items()}, **nm_k1, **nm_srv_k1,
                **nm_eval_k1, **ouvp_k1}
    k1_by_path.update({k: v for k, v in nm_paths.items() if not is_bf16(k)})
    k1_bf16_by_path.update({k: v for k, v in nm_paths.items() if is_bf16(k)})
    k3_bf16_by_path.update({k: v for k, v in nm_k3.items() if v})  # the int8 runs are bf16
    bwd_by_path = {"train": train_launches[1], **{p: r["launches"][1] for p, r in nm_runs.items()
                                                  if "bf16" not in p}}
    bwd_bf16_by_path = {"train_bf16": train_bf16["launches"][1], "bench_train": bench_bwd,
                        **{p: r["launches"][1] for p, r in nm_runs.items() if "bf16" in p}}
    ode_k1_err = max(ode_k1_err, nt_f32_err, nm_err, nm_stream_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, nt_bf16_err, nm_bf16_err, ouvp_err, nm_srv_err)
    # the distilled student (phases 46-50); phase 45's step and phase 51's
    # nf=32 calls are comparisons with plain, not counted
    d_paths = {"train_distill_bf16": d_train["launches"][0], **d_k1, **d_srv_k1, **d_eval_k1,
               "bench_distill": d_bench_k1}
    k1_by_path.update({k: v for k, v in d_paths.items() if k.endswith("float32")})
    k1_bf16_by_path.update({k: v for k, v in d_paths.items() if not k.endswith("float32")})
    k3_bf16_by_path.update({**{k: v for k, v in d_k3.items() if v},
                            "bench_distill": d_bench_k3})
    bwd_bf16_by_path["train_distill_bf16"] = d_train["launches"][1]
    ode_k1_err = max(ode_k1_err, d_err, nf32_f32_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, d_bf16_err, d_srv_err, d_bench_err, nf32_bf16_err)
    # the captured graphs (phases 52-55): their replays' launches, and the
    # eager calls they were compared with
    k1_by_path["graphs_against_eager_float32"] = g_k1_f32
    k1_bf16_by_path.update({"graphs_against_eager_bf16": g_k1 - g_k1_f32, **g_srv_k1})
    k3_bf16_by_path["graphs_against_eager_int8_bf16"] = g_k3
    ode_k1_bf16_err = max(ode_k1_bf16_err, g_srv_err)
    # the trainer's programs (phases 56-57): each mode's eager steps, its
    # program's steps and the profiled replays; the resumed trainer runs
    for r in tg_rows:
        path = "train_graphs_" + r["what"].replace(" ", "_").replace("-", "_")
        (k1_bf16_by_path if r["bf16"] else k1_by_path)[path] = r["k1_launched"][0]
        (bwd_bf16_by_path if r["bf16"] else bwd_by_path)[path] = r["k1_launched"][1]
    k1_bf16_by_path["train_resume_bf16"], bwd_bf16_by_path["train_resume_bf16"] = resume_launched
    # the NCSN++ family's other sizes and the time-domain denoisers (phases 61-64):
    # the standard instances' launches; the stride-1 instance's are its own rows
    k1_by_path.update({**large_k1, **td_k1})
    k1_bf16_by_path.update({"train_ncsnpplarge_bf16": large_train["launches"][0], **td_k1_bf16})
    bwd_bf16_by_path["train_ncsnpplarge_bf16"] = large_train["launches"][1]
    ode_k1_err = max(ode_k1_err, large_err, td_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, large_bf16_err, td_bf16_err)
    # GaGNet (phases 66-67): the score net's launches beside it
    k1_by_path.update(gs_k1)
    k1_bf16_by_path.update(gs_k1_bf16)
    k3_bf16_by_path.update(gs_k3)
    gs_train = gag_train["train_storm_gagnet_bf16"]["launches"]
    k1_bf16_by_path["train_storm_gagnet_bf16"], bwd_bf16_by_path["train_storm_gagnet_bf16"] = (
        gs_train)
    ode_k1_err = max(ode_k1_err, gs_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, gs_bf16_err)
    # multichannel input and data-parallel training (phases 69-71)
    k1_by_path.update(d2_k1)
    k1_bf16_by_path.update({**d2_k1_bf16, "train_d2_bf16": d2_train["launches"][0]})
    k3_bf16_by_path.update(d2_k3)
    bwd_bf16_by_path["train_d2_bf16"] = d2_train["launches"][1]
    k1_by_path.update(dp_k1)
    bwd_by_path.update(dp_bwd)
    ode_k1_err = max(ode_k1_err, d2_err, dp_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, d2_bf16_err, d2_train_err)
    nm_k3_err = max(nm_k3_err, d2_k3_err)
    # serving across devices on one card (phase 72)
    k1_by_path.update(sp_k1)
    k1_bf16_by_path.update(sp_k1_bf16)
    k3_bf16_by_path.update(sp_k3)
    s1_launched[("float32", "fwd")].update(sp_s1)
    ode_k1_err = max(ode_k1_err, sp_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, sp_bf16_err)
    nm_k3_err = max(nm_k3_err, sp_k3_err)
    # dataset creation and stream_quality (phases 73-74)
    k1_by_path.update(cd_k1)
    bwd_by_path.update(cd_bwd)
    k1_bf16_by_path.update(sq_k1)
    k3_bf16_by_path.update(sq_k3)
    ode_k1_err = max(ode_k1_err, cd_err)
    ode_k1_bf16_err = max(ode_k1_bf16_err, sq_err)
    nm_k3_err = max(nm_k3_err, sq_k3_err)
    print(f"  ncsnpplarge StoRM: bf16 trainer step {large_train['step_ms']:.2f} ms at B={TRAIN_B}, "
          f"peak {large_train['step_peak_gib']:.2f} GiB; one f32 step fits at B={large_f32['B']} "
          f"(peak {large_f32['peak_gib']:.2f} GiB); ConvTasNet return_time trainer step "
          f"{ctn_train['step_ms']:.2f} ms, peak {ctn_train['step_peak_gib']:.2f} GiB", flush=True)
    nt_bwd_err = max(nt_bwd_err, nf32_bwd_err, dp_bwd_err, cd_bwd_err)
    nt_bwd_bf16_err = max(nt_bwd_bf16_err, nf32_bwd_bf16_err, d2_bwd_err)
    nm_k3_err = max(nm_k3_err, d_k3_err, d_bench_k3_err, gs_k3_err)
    print(f"  distill: f32 step {d_step} launches, {d_step_ms:.2f} ms, {d_step_peak:.2f} GiB, "
          f"gradients {d_grad_err:.3e} of their norm from plain; bf16 trainer step "
          f"{d_train['step_ms']:.2f} ms, {d_train['step_peak_gib']:.2f} GiB; RTF at 4 s "
          + ", ".join(f"{k} {v:.4f}" for k, v in d_rtf.items())
          + f"; bench --distill {d_bench_line['value']} audio s/s", flush=True)
    k1_src = "storm_tpu_torch/csrc/upfirdn2d.cu"
    no_library = "no single PyTorch call computes this function"
    record = {"kernels": [
        entry("upfirdn2d", k1_src, "storm_tpu/kernels/upfirdn.py:139", per_shape, k1_calls(6),
              max(max_err, train_fwd_err, batch_err, serve_err, stream_err, dc_cli_err,
                  ode_k1_err),
              sum(k1_by_path.values()),
              f"the 18 calls of one full-width score-net forward, B=1, 256 x {FRAMES}",
              launches_by_path=k1_by_path),
        entry("upfirdn2d_bwd", k1_src, "storm_tpu/kernels/upfirdn.py:172-181", bwd_shape,
              k1_bwd_calls(), max(bwd_err, nt_bwd_err), sum(bwd_by_path.values()),
              f"the {STEP_BWD} backward calls of one full-width joint-training step, "
              f"B={TRAIN_B}, 256 x {TRAIN_FRAMES}", launches_by_path=bwd_by_path),
        entry("quantize_int8", "storm_tpu_torch/csrc/quantize_int8.cu",
              "scripts/perf_fusion_probe.py:88", k3_shape, k3_calls,
              max(k3_err, serve_k3_err, stream_k3_err, dc_k3_err),  # f32 products only
              sum(k3_by_path.values()),
              f"the {N_QUANT} quantized-conv inputs of one full-width score-net forward, "
              f"B=1, 256 x {FRAMES}, float32", library=no_library, launches_by_path=k3_by_path,
              probe={k: probe[k] for k in ("shape", "dtype", "s", "ms", "plain_ms", "bound_ms")}),
        {"name": "fused_leaky_relu", "route": "cuda", "source": "storm_tpu_torch/csrc/fused_act.cu",
         "replaces": "storm_tpu/kernels/fused_act.py:61", "launches": k2["launches"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2["bytes_ms"], k2["ops_ms"]),
         "bound_by": "bytes" if k2["bytes_ms"] >= k2["ops_ms"] else "operations",
         "library_ms": None, "work": f"forward at {K2_SHAPES[0]} float32, no mask",
         "library": no_library},
        entry("upfirdn2d_bf16", k1_src, "storm_tpu/kernels/upfirdn.py:139", bf16_shape,
              k1_calls(6), max(bf16_err, bf16_cli_err, bf16_serve_err, bf16_stream_err,
                                dc_k1_bf16_err, ode_k1_bf16_err),
              sum(k1_bf16_by_path.values()),
              f"the 18 calls of one full-width score-net forward, B=1, 256 x {FRAMES}, "
              f"bfloat16 in and out", launches_by_path=k1_bf16_by_path,
              bf16_elements_that_differ={k: {f: n[1] for f, n in v.items()}
                                         for k, v in BF16_FLIPS.items()},
              bf16_elements_compared={k: {f: n[0] for f, n in v.items()}
                                      for k, v in BF16_FLIPS.items()},
              widest_call_64s=sq_widest["upfirdn2d_bf16"]),
        entry("upfirdn2d_bwd_bf16", k1_src, "storm_tpu/kernels/upfirdn.py:172-181",
              bf16_bwd_shape, k1_bwd_calls(),
              max(bf16_err, bf16_bwd_err, bench_bwd_err, nt_bwd_bf16_err),
              sum(bwd_bf16_by_path.values()),
              f"the {STEP_BWD} backward calls of one full-width joint-training step, "
              f"B={TRAIN_B}, 256 x {TRAIN_FRAMES}, bfloat16 in and out",
              launches_by_path=bwd_bf16_by_path,
              bf16_elements_that_differ={f: n[1] for f, n in BF16_FLIPS["upfirdn2d_bwd"].items()},
              bf16_elements_compared={f: n[0] for f, n in BF16_FLIPS["upfirdn2d_bwd"].items()}),
        {"name": "fused_leaky_relu_bf16", "route": "cuda",
         "source": "storm_tpu_torch/csrc/fused_act.cu",
         "replaces": "storm_tpu/kernels/fused_act.py:61", "launches": k2_bf16["launches"],
         "max_abs_err": k2_bf16["max_abs_err"], "ms": k2_bf16["ms"],
         "device_ms": k2_bf16["device_ms"], "plain_ms": k2_bf16["plain_ms"],
         "bound_ms": max(k2_bf16["bytes_ms"], k2_bf16["ops_ms"]),
         "bound_by": "bytes" if k2_bf16["bytes_ms"] >= k2_bf16["ops_ms"] else "operations",
         "library_ms": None, "work": f"forward at {K2_SHAPES[0]} bfloat16, no mask",
         "library": no_library,
         "grad_x_ulps_of_element": k2_bf16["grad_x_ulps_of_element"],
         "grad_bias_ulps_of_scale": k2_bf16["grad_bias_ulps_of_scale"]},
        entry("quantize_int8_bf16_product", "storm_tpu_torch/csrc/quantize_int8.cu",
              "scripts/perf_fusion_probe.py:88", k3b_shape, k3b_calls,
              max(k3b_err, bf16_serve_k3_err, dc_k3_err, ode_k3_err, nm_k3_err),
              sum(k3_bf16_by_path.values()),
              f"the {N_QUANT} quantized-conv inputs of one full-width score-net forward, "
              f"B=1, 256 x {FRAMES}, bfloat16, the product in bfloat16", library=no_library,
              launches_by_path=k3_bf16_by_path,
              widest_call_64s=sq_widest["quantize_int8_bf16_product"]),
    ]}
    depthwise = "F.conv2d(groups=C) with the flipped FIR (the adjoint: the FIR as is)"
    for name, dtype_name, direction in (("upfirdn2d_s1", "float32", "fwd"),
                                        ("upfirdn2d_s1_bwd", "float32", "bwd"),
                                        ("upfirdn2d_s1_bf16", "bfloat16", "fwd"),
                                        ("upfirdn2d_s1_bwd_bf16", "bfloat16", "bwd")):
        per_shape, keys, err, by_path = s1_rows[(dtype_name, direction)]
        if (dtype_name, direction) == ("float32", "fwd"):
            err = max(err, sp_s1_err)
        paths = s1_launched[(dtype_name, direction)]
        record["kernels"].append(entry(
            name, k1_src, "storm_tpu/kernels/upfirdn.py:139" if direction == "fwd"
            else "storm_tpu/kernels/upfirdn.py:172-181", per_shape, keys, err,
            sum(paths.values()),
            (f"the {S1_PER_FORWARD} stride-1 calls of one full-width DDPM + residual NCSN++ "
             f"forward, B=1, 256 x {FRAMES}" if direction == "fwd" else
             f"the {S1_PER_FORWARD} stride-1 adjoint calls of its backward, B={TRAIN_B}, "
             f"256 x {TRAIN_FRAMES}") + f", {dtype_name}",
            launches_by_path=paths, library=depthwise, calls_by_load_and_store=by_path))
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env bash
# The port's quality record on one card: the synthetic corpus, a StoRM teacher
# (nf=32, bfloat16, early stopping on the validation loss), its quality grid,
# its one-step distilled student and the student's test-set scores.
#
#   bash storm_tpu_torch/scripts/quality_run.sh teacher OUT [WORK]
#   bash storm_tpu_torch/scripts/quality_run.sh student OUT [WORK] [TEACHER_PT]
#   bash storm_tpu_torch/scripts/quality_run.sh all OUT [WORK]
#
# OUT receives the logs, the JSON and CSV results and, after `teacher`, the
# teacher's EMA weights as OUT/teacher_ema.pt (config and EMA only), which
# `student` takes as TEACHER_PT when the two stages run on different machines.
# WORK (default ./_quality) holds the corpus and the training runs; the corpus
# is written anew by each stage (seed 0 writes the same bytes every time).
# Every step calls the port's own entry points; every wall time is printed
# beside the card's name and power limit.
set -euo pipefail
STAGE=${1:?stage: teacher, student or all}
OUT=${2:?output directory}
WORK=${3:-./_quality}
TEACHER_PT=${4:-}
CORPUS=$WORK/corpus
NUM_FILES=24
mkdir -p "$OUT" "$WORK"
PY=${PYTHON:-python}

card() { nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; }
stamp() { echo "[$(date -u +%H:%M:%S)] $* (card: $(card))"; }
timed() {  # timed NAME cmd...: the command's output in OUT/NAME.log, its wall in OUT/walls.txt
  local name=$1; shift
  local t0 t1
  t0=$(date +%s.%N)
  stamp "start $name"
  "$@" 2>&1 | tee "$OUT/$name.log"
  t1=$(date +%s.%N)
  echo "$name $(awk "BEGIN {print $t1 - $t0}") s ($(card))" | tee -a "$OUT/walls.txt"
}

if [ ! -f "$CORPUS/tt/noisy/u0031.wav" ]; then
  timed corpus $PY -m storm_tpu_torch.scripts.make_synth_corpus --root "$CORPUS"
fi

if [ "$STAGE" = teacher ] || [ "$STAGE" = all ]; then
  # the CLI's defaults but the width, the dtype and the stopping rule
  timed teacher_train $PY -m storm_tpu_torch.train --mode regen-joint-training \
    --base_dir "$CORPUS" --nf 32 --dtype bfloat16 --patience 10 --max_epochs 80 \
    --log_dir "$WORK/teacher"
  TEACHER=$(ls "$WORK"/teacher/*/checkpoints/best_loss.pt)
  cp "$(dirname "$TEACHER")/../metrics.jsonl" "$OUT/teacher_metrics.jsonl"
  $PY -c "import sys; from storm_tpu_torch.ckpt import load_training_checkpoint as l, \
save_checkpoint as s; c = l(sys.argv[1]); print('teacher best_loss.pt: step', c['step'], \
'meta', c['meta']); s(sys.argv[2], c['config'], c['ema_params'])" "$TEACHER" "$OUT/teacher_ema.pt"
  Q="$PY -m storm_tpu_torch.scripts.nfe_quality --ckpt $TEACHER --base_dir $CORPUS \
--num_files $NUM_FILES --dtype bfloat16"
  timed teacher_grid $Q --configs "pc N=50 ald,pc N=30 none,ode etd2 N=20,ode etd2 N=10,ode etd1 N=10" \
    --json "$OUT/teacher_bf16.json"
  timed teacher_int8 $Q --configs "pc N=50 ald,pc N=30 none" --quant int8 \
    --quant_min_channels 32 --json "$OUT/teacher_int8_mc32.json"
  timed teacher_dc3 $Q --configs "pc N=50 ald" --deepcache 3 --json "$OUT/teacher_dc3.json"
fi

if [ "$STAGE" = student ] || [ "$STAGE" = all ]; then
  TEACHER=${TEACHER_PT:-$(ls "$WORK"/teacher/*/checkpoints/best_loss.pt)}
  timed student_train $PY -m storm_tpu_torch.train --mode distill --teacher_ckpt "$TEACHER" \
    --distill_N 8 --distill_method etd2 --base_dir "$CORPUS" --max_epochs 20 \
    --log_dir "$WORK/student"
  STUDENT=$(ls "$WORK"/student/mode=distill*/checkpoints/best_loss.pt)
  cp "$(dirname "$STUDENT")/../metrics.jsonl" "$OUT/student_metrics.jsonl"
  E="$PY -m storm_tpu_torch.evaluate --ckpt $STUDENT --mode distill --base_dir $CORPUS \
--num_files $NUM_FILES --dtype bfloat16"
  timed student_eval_bf16 $E --csv "$OUT/student_bf16.csv"
  timed student_eval_int8 $E --quant int8 --quant_min_channels 32 --csv "$OUT/student_int8_mc32.csv"
  timed student_grid $PY -m storm_tpu_torch.scripts.nfe_quality --ckpt "$STUDENT" \
    --base_dir "$CORPUS" --num_files $NUM_FILES --dtype bfloat16 --configs "pc N=30 none" \
    --json "$OUT/student_bf16.json"
fi
stamp done

#!/bin/sh
# The shapes train-run protocol (docs/trainrun_r3/TRAINRUN.md,
# docs/trainrun_r5/run.sh) on the PyTorch port's train CLI, on the GPU:
# for each family a fresh stage, a --resume stage from the fresh stage's
# last checkpoint, and a --test-only evaluation of the last checkpoint in
# a new process. The logs land in this directory (committed unedited),
# with each stage's exit code and wall seconds in <family>_stages.log;
# docs/trainrun_torch_r1/summarize.py reads them and checks the gates.
#
# Corpus: tools/make_dataset.py --root .data/shapes --train 1500 --val 200
# at its default seed (the corpus of docs/trainrun_r3 and _r5); written
# first if .data/shapes holds no corpus.
#
# Run from the repo root on the machine with the GPU:
#   sh docs/trainrun_torch_r1/run.sh              # both families
#   sh docs/trainrun_torch_r1/run.sh ssdlite      # the flagship alone
#   sh docs/trainrun_torch_r1/run.sh pelee        # pelee304 alone
D=docs/trainrun_torch_r1
FAMILIES=${1:-"ssdlite pelee"}
mkdir -p $D runs
if [ ! -f .data/shapes/annotations/instances_val2017.json ]; then
    python tools/make_dataset.py --root .data/shapes --train 1500 --val 200
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $D/card.log

# stage NAME LOG FLAGS...: one CLI process, its output in $D/LOG
stage() {
    name=$1 log=$2
    shift 2
    t0=$(date +%s.%N)
    python -m demonet_tpu_torch.train "$@" > $D/$log 2>&1
    rc=$?
    t1=$(date +%s.%N)
    echo "$name rc=$rc seconds=$(awk "BEGIN { print $t1 - $t0 }")" \
        | tee -a $D/${name%% *}_stages.log
}

COMMON="--dataset coco --data-path .data/shapes --num-classes 91
  --warmup-iters 500 --num-workers 2 --print-freq 10 --bf16 --seed 0"

for family in $FAMILIES; do
  : > $D/${family}_stages.log
  case $family in
  # ---- the flagship: the r3 recipe exactly (no --score-thresh) ----------
  ssdlite)
    M="--model ssdlite320_mobilenet_v3_large --batch-size 32 --lr 0.02
       --lr-steps 16 20 --output-dir runs/ssdlite_torch_r1"
    stage "ssdlite stage1" ssdlite_stage1.log $COMMON $M --epochs 16
    stage "ssdlite stage2" ssdlite_stage2.log $COMMON $M --epochs 24 \
        --resume runs/ssdlite_torch_r1/checkpoint_15
    stage "ssdlite testonly" ssdlite_testonly.log $COMMON $M --test-only \
        --resume runs/ssdlite_torch_r1/checkpoint_23
    stage "ssdlite testonly_fused" ssdlite_testonly_fused.log $COMMON $M \
        --test-only --postprocess fused \
        --resume runs/ssdlite_torch_r1/checkpoint_23
    ;;
  # ---- pelee304: the r5 BN recipe ----------------------------------------
  pelee)
    M="--model pelee304 --batch-size 32 --lr 0.02 --lr-steps 10 14
       --score-thresh 0.01 --output-dir runs/pelee_torch_r1"
    stage "pelee stage1" pelee_stage1.log $COMMON $M --epochs 10
    stage "pelee stage2" pelee_stage2.log $COMMON $M --epochs 16 \
        --resume runs/pelee_torch_r1/checkpoint_9
    stage "pelee testonly" pelee_testonly.log $COMMON $M --test-only \
        --resume runs/pelee_torch_r1/checkpoint_15
    ;;
  *)
    echo "unknown family: $family (ssdlite or pelee)"
    exit 2
    ;;
  esac
done
echo "ALL DONE"

#!/bin/sh
# The shapes train-run protocol (docs/trainrun_r3/TRAINRUN.md,
# docs/trainrun_r5/run.sh) on the PyTorch port's train CLI, on the GPU:
# for each family a fresh stage, a --resume stage from the fresh stage's
# last checkpoint, and a --test-only evaluation of the last checkpoint in
# a new process. The logs land in this directory (committed unedited),
# with each stage's exit code and wall seconds in <family>_stages.log,
# and one line a call in card.log: the families run and the card
# (nvidia-smi's name and power limit);
# docs/trainrun_torch_r1/summarize.py reads them and checks the gates.
# After each stage the family's checkpoints that no later stage reads are
# deleted (a VGG detector's is ~300 MB, model and momentum in float32).
#
# Corpus: tools/make_dataset.py --root .data/shapes --train 1500 --val 200
# at its default seed (the corpus of docs/trainrun_r3 and _r5); written
# first if .data/shapes holds no corpus.
#
# Run from the repo root on the machine with the GPU:
#   sh docs/trainrun_torch_r1/run.sh              # all five families
#   sh docs/trainrun_torch_r1/run.sh ssdlite      # the flagship alone
#   sh docs/trainrun_torch_r1/run.sh pelee        # pelee304 alone
#   sh docs/trainrun_torch_r1/run.sh sslv2        # ssd_lite_mobilenet_v2
#   sh docs/trainrun_torch_r1/run.sh vgg300       # ssd300_vgg16
#   sh docs/trainrun_torch_r1/run.sh vgg512       # ssd512_vgg16
# A family's stages read its checkpoints under runs/, so they run in one
# call of this script.
D=docs/trainrun_torch_r1
FAMILIES=${1:-"ssdlite pelee sslv2 vgg300 vgg512"}
mkdir -p $D runs
if [ ! -f .data/shapes/annotations/instances_val2017.json ]; then
    python tools/make_dataset.py --root .data/shapes --train 1500 --val 200
fi
echo "$FAMILIES: $(nvidia-smi --query-gpu=name,power.limit \
    --format=csv,noheader)" >> $D/card.log
df -h . >&2

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

# keep OUT E: delete OUT's checkpoints but checkpoint_E (a later stage
# reads it)
keep() {
    for c in "$1"/checkpoint_*; do
        if [ -d "$c" ] && [ "$c" != "$1/checkpoint_$2" ]; then
            rm -rf "$c" "$c.meta.json"
        fi
    done
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
    keep runs/ssdlite_torch_r1 15
    stage "ssdlite stage2" ssdlite_stage2.log $COMMON $M --epochs 24 \
        --resume runs/ssdlite_torch_r1/checkpoint_15
    keep runs/ssdlite_torch_r1 23
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
    keep runs/pelee_torch_r1 9
    stage "pelee stage2" pelee_stage2.log $COMMON $M --epochs 16 \
        --resume runs/pelee_torch_r1/checkpoint_9
    keep runs/pelee_torch_r1 15
    stage "pelee testonly" pelee_testonly.log $COMMON $M --test-only \
        --resume runs/pelee_torch_r1/checkpoint_15
    ;;
  # ---- ssd_lite_mobilenet_v2: the r5 BN recipe ---------------------------
  sslv2)
    O=runs/sslv2_torch_r1
    M="--model ssd_lite_mobilenet_v2 --batch-size 32 --lr 0.02
       --lr-steps 10 14 --score-thresh 0.01 --output-dir $O"
    stage "sslv2 stage1" sslv2_stage1.log $COMMON $M --epochs 10
    keep $O 9
    stage "sslv2 stage2" sslv2_stage2.log $COMMON $M --epochs 16 \
        --resume $O/checkpoint_9
    keep $O 15
    stage "sslv2 testonly" sslv2_testonly.log $COMMON $M --test-only \
        --resume $O/checkpoint_15
    ;;
  # ---- ssd300_vgg16: the r4 recipe exactly (no trunk BN, lr 0.001, no
  # --score-thresh); a fused test-only beside the reference one ----------
  vgg300)
    O=runs/vgg300_torch_r1
    M="--model ssd300_vgg16 --batch-size 32 --lr 0.001 --lr-steps 22 26
       --output-dir $O"
    stage "vgg300 stage1" vgg300_stage1.log $COMMON $M --epochs 16
    keep $O 15
    stage "vgg300 stage2" vgg300_stage2.log $COMMON $M --epochs 28 \
        --resume $O/checkpoint_15
    keep $O 27
    stage "vgg300 testonly" vgg300_testonly.log $COMMON $M --test-only \
        --resume $O/checkpoint_27
    stage "vgg300 testonly_fused" vgg300_testonly_fused.log $COMMON $M \
        --test-only --postprocess fused --resume $O/checkpoint_27
    ;;
  # ---- ssd512_vgg16: the r5 VGG recipe (b16 for 512x512) -----------------
  vgg512)
    O=runs/vgg512_torch_r1
    M="--model ssd512_vgg16 --batch-size 16 --lr 0.001 --lr-steps 18 22
       --score-thresh 0.01 --output-dir $O"
    stage "vgg512 stage1" vgg512_stage1.log $COMMON $M --epochs 14
    keep $O 13
    stage "vgg512 stage2" vgg512_stage2.log $COMMON $M --epochs 24 \
        --resume $O/checkpoint_13
    keep $O 23
    stage "vgg512 testonly" vgg512_testonly.log $COMMON $M --test-only \
        --resume $O/checkpoint_23
    ;;
  *)
    echo "unknown family: $family (ssdlite, pelee, sslv2, vgg300 or vgg512)"
    exit 2
    ;;
  esac
done
echo "ALL DONE"

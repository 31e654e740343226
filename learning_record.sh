#!/usr/bin/env bash
# The port's learning record on one GPU: cascade.yml trained from the
# procedural Pororo tree, then its checkpoints walked with FID / FSD and SSIM.
#
#   bash learning_record.sh [WORK_DIR] [EPOCHS] [RESULTS_DIR]
#
# WORK_DIR (default build/record) receives the dataset and the run; a copy
# of cascade.yml with a snapshot every 2 epochs (SNAPSHOT_INTERVAL 2 instead
# of 10) is trained for EPOCHS (default 10) epochs through the port's CLI,
# then --eval_fid 1 and --eval_ssim 1 walk every snapshot. fid_score2.csv,
# ssim_score.csv, metrics.jsonl and the last sample grid are copied to
# RESULTS_DIR (default WORK_DIR/results). The metric backbones run from
# random init unless $CPCSV_METRIC_WEIGHTS_DIR holds weights.
set -euo pipefail

repo="$(cd "$(dirname "$0")" && pwd)"
work="$(mkdir -p "${1:-build/record}" && cd "${1:-build/record}" && pwd)"
epochs="${2:-10}"
results="$(mkdir -p "${3:-$work/results}" && cd "${3:-$work/results}" && pwd)"
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"

cd "$work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m cpcsv_tpu_torch.data.procedural pororo
sed 's/SNAPSHOT_INTERVAL: 10/SNAPSHOT_INTERVAL: 2/' \
    "$repo/cpcsv_tpu_torch/configs/cascade.yml" > cascade_snapshot2.yml
grep -q 'SNAPSHOT_INTERVAL: 2$' cascade_snapshot2.yml
cli=(python -m cpcsv_tpu_torch.cli.main_pororo --cfg cascade_snapshot2.yml --data_dir pororo)
start=$(date +%s)
"${cli[@]}" --max_epoch "$epochs" | grep -E '^----\['
echo "training: $(( $(date +%s) - start )) s for $epochs epochs"
start=$(date +%s)
"${cli[@]}" --eval_fid 1 | grep -E '^epoch '
echo "--eval_fid walk: $(( $(date +%s) - start )) s"
start=$(date +%s)
"${cli[@]}" --eval_ssim 1 | grep -E '^epoch '
echo "--eval_ssim walk: $(( $(date +%s) - start )) s"

run=output/torch/cascade_model
cp "$run/Evaluation/cascade_model/fid_score2.csv" "$run/Evaluation/cascade_model/ssim_score.csv" \
   "$run/log/metrics.jsonl" "$results/"
cp "$(ls "$run"/log/pororo_*.png | tail -n 1)" "$results/"
echo "results in $results"

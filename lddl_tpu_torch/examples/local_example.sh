#!/bin/bash
# End-to-end single-host recipe on the PyTorch port alone (counterpart of
# examples/local_example.sh): corpus -> vocab -> preprocess -> balance ->
# the loader harness on 2 simulated dp groups -> binning validation ->
# the BART family -> sequence packing. Zero-egress friendly: a synthetic
# Wikipedia-like corpus; swap stage 1 for
# `python -m lddl_tpu_torch.download.wikipedia --outdir $DATA/wiki` on a
# connected machine. No stage trains a model, so no stage touches a GPU:
# add `--with-model base` to a mock_train stage to run the train step on
# the card.
set -euo pipefail

DATA=${DATA:-/tmp/lddl_tpu_example}
SEQ_LEN=${SEQ_LEN:-128}
BIN_SIZE=${BIN_SIZE:-32}
NUM_SHARDS=${NUM_SHARDS:-8}
cd "$(dirname "$0")/../.."

rm -rf "$DATA"
mkdir -p "$DATA"

echo "== 1. corpus (synthetic; see download.wikipedia for the real one) =="
python - "$DATA" <<'PY'
import os, sys
from lddl_tpu_torch.testing import make_corpus
n, _ = make_corpus(os.path.join(sys.argv[1], "wiki"), target_mb=4, shards=4)
print("corpus bytes:", n)
PY

echo "== 2. vocab =="
python - "$DATA" <<'PY'
import sys, glob
from lddl_tpu_torch.preprocess import build_wordpiece_vocab
texts = []
for p in glob.glob(sys.argv[1] + "/wiki/source/*.txt"):
    with open(p) as f:
        for i, line in enumerate(f):
            texts.append(line.split(None, 1)[1])
            if i > 500: break
build_wordpiece_vocab(texts, sys.argv[1] + "/vocab.txt", vocab_size=8192)
PY

echo "== 3. preprocess (binned, static masking) =="
# add "--splitter learned" for punkt-grade segmentation (corpus-trained
# parameters)
python -m lddl_tpu_torch.cli.preprocess_bert_pretrain \
  --wikipedia "$DATA/wiki" \
  --sink "$DATA/pre" \
  --vocab-file "$DATA/vocab.txt" \
  --target-seq-length "$SEQ_LEN" \
  --bin-size "$BIN_SIZE" \
  --masking \
  --duplicate-factor 2 \
  --sample-ratio 1.0 \
  --num-blocks 8

echo "== 4. balance =="
python -m lddl_tpu_torch.cli.balance_shards \
  --indir "$DATA/pre" --outdir "$DATA/bal" --num-shards "$NUM_SHARDS"

echo "== 5. mock training (2 simulated dp groups) =="
for RANK in 0 1; do
  python -m lddl_tpu_torch.tools.mock_train \
    --path "$DATA/bal" \
    --vocab-file "$DATA/vocab.txt" \
    --batch-size 32 \
    --epochs 1 \
    --log-freq 20 \
    --dp-rank "$RANK" --num-dp-groups 2 \
    --fixed-seq-lengths 32 64 96 128 \
    --seq-len-dir "$DATA/seqlens"
done

echo "== 6. validate binning + sync =="
python -m lddl_tpu_torch.tools.validate_seqlen \
  --seq-len-dir "$DATA/seqlens" --bin-size "$BIN_SIZE"

echo "== 7. BART family (preprocess -> balance -> loader) =="
python -m lddl_tpu_torch.cli.preprocess_bart_pretrain \
  --wikipedia "$DATA/wiki" \
  --sink "$DATA/bart_pre" \
  --target-seq-length 128 \
  --num-blocks 8 \
  --sample-ratio 1.0 \
  --seed 0
python -m lddl_tpu_torch.cli.balance_shards \
  --indir "$DATA/bart_pre" --outdir "$DATA/bart_bal" --num-shards 4
python -m lddl_tpu_torch.tools.mock_train \
  --family bart \
  --path "$DATA/bart_bal" \
  --vocab-file "$DATA/vocab.txt" \
  --batch-size 32 \
  --epochs 1 \
  --log-freq 20 \
  --fixed-seq-lengths 128

echo "== 8. sequence packing (unbinned preprocess -> packed loader) =="
python -m lddl_tpu_torch.cli.preprocess_bert_pretrain \
  --wikipedia "$DATA/wiki" \
  --sink "$DATA/pre_unb" \
  --vocab-file "$DATA/vocab.txt" \
  --target-seq-length "$SEQ_LEN" \
  --duplicate-factor 2 \
  --sample-ratio 1.0 \
  --num-blocks 8
python -m lddl_tpu_torch.cli.balance_shards \
  --indir "$DATA/pre_unb" --outdir "$DATA/bal_unb" --num-shards "$NUM_SHARDS"
python - "$DATA" <<'PY'
import sys
from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
loader = get_bert_pretrain_data_loader(
    sys.argv[1] + "/bal_unb", vocab_file=sys.argv[1] + "/vocab.txt",
    batch_size=32, pack_seq_length=256, pack_rows=8)
n = sum(1 for _ in loader)
print("packed: {} batches of [8, 256], {} samples, pad ratio {:.2%}".format(
    n, loader.n_samples, loader.pad_ratio))
PY

echo "example complete: $DATA"

#!/usr/bin/env bash
# Sigmoid-manifold padding sweep: default seed + seeds 24/48 over the
# (data-dim, padding, latent) grid. Same runs as the reference script
# (reference/sigmoid_vae_padding_expts.sh), expressed as a loop.
# 150k batches, linear enc/dec, epsilon = -3, tunable decoder variance.
set -e

GRID=(
  "3 3 6"
  "3 13 8"
  "5 16 16"
  "5 5 10"
  "7 7 13"
  "7 20 24"
)

for seed in "" 24 48; do
  for row in "${GRID[@]}"; do
    read -r dd pd ld <<<"$row"
    name="sigmoid_dd${dd}_pd${pd}_ld_${ld}_eps-3"
    seed_args=()
    if [[ -n "$seed" ]]; then
      name="${name}_seed${seed}"
      seed_args=(--dataset_seed "$seed")
    fi
    python run.py "$name" \
      --dataset sigmoid --encoder_layer_sizes "" --layer_sizes "" \
      -ow --latent_dim "$ld" --padding_dim "$pd" -dd "$dd" \
      --num_batches 150000 --epsilon -3 -tdv "${seed_args[@]}" "$@"
  done
done

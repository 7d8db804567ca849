#!/usr/bin/env bash
# Linear-gaussian padding sweep: 3 dataset seeds × the (data-dim, padding,
# latent) grid of the original experiment set. Produces the same runs as the
# reference script (reference/seed_linpadding_expts.sh), expressed as a
# loop over the grid. 100k batches, linear enc/dec, Adam 1e-3, tunable
# decoder variance, epsilon = -1.
set -e

# rows: data_dim padding_dim latent_dim  (ambient = data_dim + padding_dim)
GRID=(
  "3 9 20"
  "3 17 20"
  "6 6 20"
  "6 14 20"
  "9 3 20"
  "9 11 10"
  "12 8 10"
)

for seed in 2 3 4; do
  for row in "${GRID[@]}"; do
    read -r dd pd ld <<<"$row"
    ndim=$((dd + pd))
    python run.py "vae${dd}linear_gaussian_${ndim}dim${seed}" \
      --dataset linear_gaussian --encoder_layer_sizes "" --layer_sizes "" \
      -ow --latent_dim "$ld" --padding_dim "$pd" -dd "$dd" \
      --num_batches 100000 --epsilon -1 -tdv -ds "$seed" -lr 1e-3 "$@"
  done
done

#!/bin/bash
# Time two checkouts of the port on one card in turns: A, B, B, A.
#
#   tools/chip_smoke_ab.sh A_DIR B_DIR [OUT_DIR]
#
# Runs chip_smoke.py from the root of each checkout (each builds its own
# kernels into its own build/), in the order A, B, B, A, and copies each
# run's stdout and build/chip_smoke.json to OUT_DIR/run{1..4}.{txt,json}
# (default build/ab).  Two versions are compared only within one
# such call: the card, its power limit and its neighbours stay the same.
set -u
A=$(cd "$1" && pwd)
B=$(cd "$2" && pwd)
OUT=$(mkdir -p "${3:-build/ab}" && cd "${3:-build/ab}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for d in "$A" "$B" "$B" "$A"; do
  i=$((i + 1))
  (cd "$d" && timeout 420 python3 chip_smoke.py > "$OUT/run$i.txt" 2>&1
   echo "run $i ($d): exit $?"
   cp build/chip_smoke.json "$OUT/run$i.json")
done

# Runs of one cell, one process after another, as the bounds are measured:
#   bash ecbench/explore/sets.sh <tag> <cell> <seconds> <trace> <seed>... [T <seed>...]
# Seeds after "T" run with --trace 1. Each run's output goes to
# $OUT/<tag>_<seed>_<trace>.{out,err} (OUT defaults to build/ecbench/runs);
# the card's name, power limit, clock and temperature are printed before
# and after.
OUT=${OUT:-build/ecbench/runs}
mkdir -p "$OUT"
tag=$1; cell=$2; secs=$3; tr=$4; shift 4
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
for s in "$@"; do
  if [ "$s" = T ]; then tr=1; continue; fi
  t0=$(date +%s%N)
  python3 -m ecbench --workload "$cell" --seed "$s" --seconds "$secs" --trace "$tr" \
    > "$OUT/${tag}_${s}_$tr.out" 2> "$OUT/${tag}_${s}_$tr.err"
  rc=$?
  t1=$(date +%s%N)
  echo "== ${tag}_${s}_$tr rc=$rc wall_ms=$(( (t1 - t0) / 1000000 ))"
  tail -n 1 "$OUT/${tag}_${s}_$tr.out" | cut -c1-600
  grep -E "^ecbench: (setup|traced|checked|repair routes)" "$OUT/${tag}_${s}_$tr.err" | cut -c1-200
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader

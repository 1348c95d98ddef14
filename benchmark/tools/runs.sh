#!/bin/sh
# Run cells of the benchmark several times in one process tree, each run's
# output kept under OUT: runs.sh OUT SECONDS TRACE WORKLOAD SEED [SEED ...]
out=$1; secs=$2; trace=$3; wl=$4; shift 4
mkdir -p "$out"
for seed in "$@"; do
  t0=$(date +%s)
  python3 benchmark/run.py --workload "$wl" --seed "$seed" --seconds "$secs" --trace "$trace" \
    > "$out/$wl.$seed.$trace.out" 2> "$out/$wl.$seed.$trace.err"
  rc=$?
  t1=$(date +%s)
  echo "== $wl seed $seed trace $trace rc $rc wall $((t1 - t0))"
  tail -n 1 "$out/$wl.$seed.$trace.out" | cut -c1-1500
  grep -E '^check |"draw"' "$out/$wl.$seed.$trace.err" | tail -n 5
  [ $rc -ne 0 ] && tail -n 25 "$out/$wl.$seed.$trace.err"
done
exit 0

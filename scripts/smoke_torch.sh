#!/usr/bin/env bash
# HTTP serving smoke of the PyTorch/CUDA port: start the port's SSE
# frontend (python -m repro_torch.launch.serve --serve-http) on the tiny
# arch with the device-resident loop (--host-stride 4), curl streamed and
# non-streamed completions, and assert
#   - stream token-concat == the non-streamed token_ids,
#   - reduced == softmax greedy output over HTTP (Theorem 1 end to end),
#   - a seeded temperature request gives the same tokens twice,
#   - spec_k is refused with a JSON 400 (it excludes host_stride),
#   - /healthz answers 200 with ok:true, unknown paths 404 with JSON,
#   - /v1/stats: host_syncs == prefills + decode_steps, and the loop
#     amortised the syncs (tokens_per_dispatch > 1);
# then runs the batch CLI at --host-stride 1 and 4 and checks both
# served every request.
#
#   bash scripts/smoke_torch.sh --device cpu [PORT]    # this machine
#   bash scripts/smoke_torch.sh [PORT]                 # on the card
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cuda
if [ "${1:-}" = "--device" ]; then DEVICE="$2"; shift 2; fi
PORT="${1:-8972}"
BASE="http://127.0.0.1:$PORT"
TMP="$(mktemp -d)"

python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
    --device "$DEVICE" --serve-http "$PORT" --slots 2 --max-len 64 \
    --host-stride 4 &
SRV=$!
trap 'kill "$SRV" 2>/dev/null || true; wait "$SRV" 2>/dev/null || true; rm -rf "$TMP"' EXIT

echo "waiting for $BASE/v1/stats ..."
for _ in $(seq 1 120); do
    curl -sf "$BASE/v1/stats" >/dev/null 2>&1 && break
    kill -0 "$SRV" 2>/dev/null || { echo "server died"; exit 1; }
    sleep 1
done
curl -sf "$BASE/v1/stats" >/dev/null

curl -sf "$BASE/healthz" > "$TMP/healthz.json"
curl -s -o "$TMP/notfound.json" -w '%{http_code}' \
    "$BASE/no/such/path" > "$TMP/notfound.code"
BODY='{"prompt": [5, 11, 7, 3, 19, 2, 5, 11], "max_new_tokens": 10}'
curl -sf -X POST "$BASE/v1/completions" -d "$BODY" > "$TMP/full.json"
curl -sfN -X POST "$BASE/v1/completions" \
    -d "${BODY%\}}, \"stream\": true}" > "$TMP/stream.txt"
curl -sf -X POST "$BASE/v1/completions" \
    -d "${BODY%\}}, \"head_mode\": \"softmax\"}" > "$TMP/softmax.json"
for n in 1 2; do
    curl -sf -X POST "$BASE/v1/completions" -d "${BODY%\}}, \
\"head_mode\": \"temperature\", \"temperature\": 0.7, \"seed\": 3}" \
        > "$TMP/temp$n.json"
done
curl -s -o "$TMP/spec.json" -w '%{http_code}' -X POST \
    "$BASE/v1/completions" -d "${BODY%\}}, \"spec_k\": 4}" \
    > "$TMP/spec.code"
curl -sf "$BASE/v1/stats" > "$TMP/stats.json"

TMP="$TMP" python - <<'PY'
import json, os
tmp = os.environ["TMP"]
assert json.load(open(f"{tmp}/healthz.json"))["ok"] is True
nf = json.load(open(f"{tmp}/notfound.json"))
assert open(f"{tmp}/notfound.code").read().strip() == "404" and "error" in nf
full = json.load(open(f"{tmp}/full.json"))
soft = json.load(open(f"{tmp}/softmax.json"))
temps = [json.load(open(f"{tmp}/temp{n}.json")) for n in (1, 2)]
lines = [l[6:] for l in open(f"{tmp}/stream.txt") if l.startswith("data: ")]
assert lines[-1].strip() == "[DONE]", lines[-1]
chunks = [json.loads(l) for l in lines[:-1]]
streamed = [c["token"] for c in chunks]
assert streamed == full["token_ids"], (streamed, full["token_ids"])
assert chunks[-1]["finish_reason"] is not None, chunks[-1]
assert soft["token_ids"] == full["token_ids"], "Theorem 1 violated over HTTP"
assert temps[0]["token_ids"] == temps[1]["token_ids"], temps
assert open(f"{tmp}/spec.code").read().strip() == "400"
assert "host_stride" in json.load(open(f"{tmp}/spec.json"))["error"]
stats = json.load(open(f"{tmp}/stats.json"))["engine"]
assert stats["host_syncs"] == stats["prefills"] + stats["decode_steps"], stats
tpd = stats["tokens_per_dispatch"]
assert abs(tpd - stats["emitted_tokens"] / stats["host_syncs"]) < 1e-9
assert tpd > 1.0, stats
print(f"HTTP SMOKE OK (port, host_stride 4): {len(streamed)} streamed "
      f"tokens == non-streamed, reduced == softmax, seeded temperature "
      f"repeatable, spec_k refused, healthz ok, 404s JSON, "
      f"host_syncs {stats['host_syncs']} == prefills + decode_steps, "
      f"{tpd:.2f} tok/dispatch")
PY

for stride in 1 4; do
    python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
        --device "$DEVICE" --requests 6 --slots 3 --host-stride "$stride" \
        | tee "$TMP/cli$stride.txt"
    grep -q "served=6 " "$TMP/cli$stride.txt"
done
echo "CLI SMOKE OK (port, host_stride 1 and 4)"

"""The port's tools, run as modules (`python3 -m
libplacebo_tpu_torch.tools.bench_micro --json out.json`): the per-pass
micro-benchmark and its differ, the playback and stage benchmarks, the
options document, the API-parity check, and the multi-device tools that
run on gloo ranks on the CPU."""

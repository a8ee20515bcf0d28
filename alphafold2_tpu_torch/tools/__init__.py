"""The serving tools of the port (counterparts of the JAX package's
`tools/`), each run as `python -m alphafold2_tpu_torch.tools.<name>`:

- obs_report:    per-stage latency waterfall and the trace tripwire
- obs_fleet:     fleet-merged traces, expositions and controller logs
- serve_loadtest: closed-loop load test of the serving stack
- cache_warm:    fold the traffic head into the fold cache ahead of time
- bulk_submit:   proteome-scale bulk campaigns against the front doors
- serve_smoke.sh: the serving regression smoke over the tools above
"""

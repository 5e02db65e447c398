"""Inference server CLI — `python -m clip_dplm_tpu_torch.experiments.serve`.

Serves pooled protein embeddings (ESM tower) and DPLM generation over HTTP
with micro-batched dispatch (clip_dplm_tpu_torch/serving.py), on one device.
Weights are random, drawn from a seeded generator on that device:

  python -m clip_dplm_tpu_torch.experiments.serve --allow-random \
      --esm esm2_t33_650M --dplm-random --port 8000

  curl -s localhost:8000/healthz
  curl -s -XPOST localhost:8000/v1/embed -d '{"sequences": ["MKTAYIAK"]}'
  curl -s -XPOST localhost:8000/v1/generate -d '{"lengths": [60, 124]}'
  curl -s localhost:8000/v1/stats
"""

from __future__ import annotations

import argparse
import signal
import threading

import torch

from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.models.dplm import DPLM
from clip_dplm_tpu_torch.models.esm import ESMTower, esm_config_from_name
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.serving import EmbedService, GenerateService, make_server


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    return device


def build_services(args):
    """(embed_service | None, generate_service | None) per CLI flags."""
    device = _device(args.device)
    embed_svc = None
    if not args.no_embed:
        if not args.allow_random:
            raise SystemExit(
                "pass --allow-random to serve RANDOM weights: the port loads "
                "no checkpoints yet")
        tower = ESMTower(esm_config_from_name(args.esm, max_len=args.max_len),
                         device=device)
        init_params(tower, torch.Generator(device=device).manual_seed(0))
        print("WARNING: serving RANDOM embedding weights")
        embed_svc = EmbedService(
            tower.eval(), pooling=args.pooling, max_len=args.max_len,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)

    gen_svc = None
    if args.dplm_random:
        cfg = DPLMConfig(d_model=args.dplm_d_model,
                         num_layers=args.dplm_layers,
                         num_heads=max(2, args.dplm_d_model // 64),
                         max_len=args.gen_max_len + 2)
        model = DPLM(cfg, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(1))
        print("WARNING: serving RANDOM DPLM weights")
        gen_svc = GenerateService(
            model.eval(), max_len=args.gen_max_len, num_steps=args.gen_steps,
            temperature=args.gen_temperature, max_batch=args.gen_max_batch,
            max_wait_ms=args.max_wait_ms)
    return embed_svc, gen_svc


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--esm", default="esm2_t6_8M",
                        help="ESM-2 family of the embed tower")
    parser.add_argument("--allow-random", action="store_true",
                        help="permit serving random weights (smoke only)")
    parser.add_argument("--no-embed", action="store_true")
    parser.add_argument("--pooling", default="mean_residues",
                        choices=["mean_residues", "cls"])
    parser.add_argument("--max-len", type=int, default=1024)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--dplm-random", action="store_true",
                        help="serve a fresh random DPLM (smoke only)")
    parser.add_argument("--dplm-d-model", type=int, default=640)
    parser.add_argument("--dplm-layers", type=int, default=12)
    parser.add_argument("--gen-max-len", type=int, default=126)
    parser.add_argument("--gen-steps", type=int, default=None)
    parser.add_argument("--gen-temperature", type=float, default=1.0)
    parser.add_argument("--gen-max-batch", type=int, default=32)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    embed_svc, gen_svc = build_services(args)
    if embed_svc is None and gen_svc is None:
        raise SystemExit("nothing to serve: --no-embed without --dplm-random")
    server = make_server(embed=embed_svc, generate=gen_svc,
                         host=args.host, port=args.port)
    endpoints = ["/healthz", "/v1/stats"]
    if embed_svc is not None:
        endpoints.append("/v1/embed")
    if gen_svc is not None:
        endpoints.append("/v1/generate")
    print(f"serving on http://{args.host}:{server.server_port} "
          f"({', '.join(endpoints)}) — ctrl-c to stop")
    # SIGTERM drains like ctrl-c; shutdown() from the serving thread would
    # deadlock, so a helper thread calls it
    signal.signal(signal.SIGTERM, lambda s, f: threading.Thread(
        target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if embed_svc is not None:
            embed_svc.close()
        if gen_svc is not None:
            gen_svc.close()


if __name__ == "__main__":
    main()

"""Inference server CLI — `python -m clip_dplm_tpu_torch.experiments.serve`.

Serves pooled protein embeddings (ESM tower) and DPLM generation over HTTP
with micro-batched dispatch (clip_dplm_tpu_torch/serving.py), on one device.
Weights come from pretrained bundles (utils/pretrained.py, written by either
package): `--bundle` (an ESM-2 tower, or an esm_clip model's) for /v1/embed,
`--dplm-bundle` for /v1/generate, `--scorer-bundle` (an esm_clip model: its
protein tower and projection; or an ESM-2 tower) to CLIP-guide generation:

  python -m clip_dplm_tpu_torch.experiments.serve --bundle runs/esm2_650m \
      --dplm-bundle runs/dplm --scorer-bundle runs/esm_clip \
      --conditions-npz conditions.npz --gen-candidates 8 --port 8000

  curl -s localhost:8000/healthz
  curl -s -XPOST localhost:8000/v1/embed -d '{"sequences": ["MKTAYIAK"]}'
  curl -s -XPOST localhost:8000/v1/generate -d '{"lengths": [60, 124]}'
  curl -s -XPOST localhost:8000/v1/generate \
      -d '{"lengths": [60], "condition_id": "rbp_a"}'
  curl -s localhost:8000/v1/stats

Without bundles, random weights drawn from a seeded generator on the device
(smoke and bench only): `--allow-random --esm esm2_t33_650M --dplm-random`,
and `--guided-random` guides with the embed tower itself. Conditions from an
.npz (`--conditions-npz`) are (d,) embeddings, d the scorer's width.
"""

from __future__ import annotations

import argparse
import signal
import threading

import numpy as np
import torch

from clip_dplm_tpu_torch.config import DPLMConfig
from clip_dplm_tpu_torch.models.dplm import DPLM
from clip_dplm_tpu_torch.models.esm import ESMTower, esm_config_from_name
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.serving import EmbedService, GenerateService, make_server
from clip_dplm_tpu_torch.utils.pretrained import (
    dplm_of,
    esm_tower_of,
    load_pretrained,
    scorer_of,
)


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
        if args.bundle:
            tower = esm_tower_of(load_pretrained(args.bundle, device=device)[1])
        else:
            if not args.allow_random:
                raise SystemExit(
                    "no --bundle given: pass --allow-random to serve RANDOM weights (smoke "
                    "and bench only), or write a bundle (utils/pretrained.py)")
            tower = ESMTower(esm_config_from_name(args.esm, max_len=args.max_len),
                             device=device)
            init_params(tower, torch.Generator(device=device).manual_seed(0))
            print("WARNING: serving RANDOM embedding weights")
        embed_svc = EmbedService(
            tower.eval(), pooling=args.pooling, max_len=args.max_len,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)

    gen_svc = None
    if args.dplm_bundle or args.dplm_random:
        if args.dplm_bundle:
            model = dplm_of(load_pretrained(args.dplm_bundle, device=device)[1])
        else:
            cfg = DPLMConfig(d_model=args.dplm_d_model,
                             num_layers=args.dplm_layers,
                             num_heads=max(2, args.dplm_d_model // 64),
                             max_len=args.gen_max_len + 2)
            model = DPLM(cfg, device=device)
            init_params(model, torch.Generator(device=device).manual_seed(1))
            print("WARNING: serving RANDOM DPLM weights")
        scorer = None
        if args.scorer_bundle:
            scorer = scorer_of(load_pretrained(args.scorer_bundle, device=device)[1])
        elif args.guided_random:
            if embed_svc is None:
                raise SystemExit("--guided-random reuses the embed tower as the scorer; "
                                 "it cannot be combined with --no-embed")
            tower = embed_svc.tower

            def scorer(toks, mask):
                return tower(toks, mask, pooling="mean_residues")
        conditions = None
        if args.conditions_npz:
            data = np.load(args.conditions_npz)
            conditions = {k: data[k] for k in data.files}
        gen_svc = GenerateService(
            model.eval(), max_len=args.gen_max_len, num_steps=args.gen_steps,
            temperature=args.gen_temperature, max_batch=args.gen_max_batch,
            max_wait_ms=args.max_wait_ms, scorer=scorer,
            num_candidates=args.gen_candidates, conditions=conditions)
    elif args.scorer_bundle:
        raise SystemExit("--scorer-bundle guides /v1/generate: give --dplm-bundle "
                         "(or --dplm-random)")
    return embed_svc, gen_svc


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bundle", default=None,
                        help="pretrained bundle of the embed tower (an ESM-2 tower or an "
                             "esm_clip model)")
    parser.add_argument("--esm", default="esm2_t6_8M",
                        help="ESM-2 family of a random embed tower (no --bundle)")
    parser.add_argument("--allow-random", action="store_true",
                        help="permit serving random weights (smoke only)")
    parser.add_argument("--no-embed", action="store_true")
    parser.add_argument("--pooling", default="mean_residues",
                        choices=["mean_residues", "cls"])
    parser.add_argument("--max-len", type=int, default=1024)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--dplm-bundle", default=None,
                        help="pretrained bundle of the DPLM for /v1/generate")
    parser.add_argument("--dplm-random", action="store_true",
                        help="serve a fresh random DPLM (smoke only)")
    parser.add_argument("--dplm-d-model", type=int, default=640)
    parser.add_argument("--dplm-layers", type=int, default=12)
    parser.add_argument("--gen-max-len", type=int, default=126)
    parser.add_argument("--gen-steps", type=int, default=None)
    parser.add_argument("--gen-temperature", type=float, default=1.0)
    parser.add_argument("--gen-max-batch", type=int, default=32)
    parser.add_argument("--scorer-bundle", default=None,
                        help="pretrained bundle scoring guided generation (an esm_clip "
                             "model: esm_tower + protein_proj; or an ESM-2 tower)")
    parser.add_argument("--guided-random", action="store_true",
                        help="guide /v1/generate with the embed tower (smoke only)")
    parser.add_argument("--gen-candidates", type=int, default=4,
                        help="best-of-K candidates for guided sampling")
    parser.add_argument("--conditions-npz", default=None,
                        help=".npz of named conditioning embeddings, referenced "
                             "by condition_id")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    embed_svc, gen_svc = build_services(args)
    if embed_svc is None and gen_svc is None:
        raise SystemExit("nothing to serve: --no-embed without a DPLM flag")
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

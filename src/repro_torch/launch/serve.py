"""Serving entry point: batched prefill + greedy decode at a config's smoke size.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
      --batch 4 --prompt-len 32 --new-tokens 16

Runs on the GPU unless ``--device cpu`` is given (and raises without CUDA
otherwise). The reference's flags and ``.smoke()`` config; parameters are
the port's own initialisation from seed 0.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import get_config
from repro_torch.models.registry import build_model, make_batch
from repro_torch.serve.serve_loop import Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    model = build_model(cfg)
    params = model.init(0, args.device)
    server = Server(model, params, max_len=args.prompt_len + args.new_tokens + 8,
                    device=args.device)

    batch = make_batch(cfg, batch=args.batch, seq=args.prompt_len,
                       kind="prefill", device=args.device)
    t0 = time.time()
    out = server.generate(batch, args.new_tokens)
    dt = time.time() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({server.stats.decode_tokens / dt:.1f} tok/s)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()

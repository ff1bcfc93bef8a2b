"""Serving launcher: prefill + batched decode with a KV/state cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The port of ``repro.launch.serve``, with the same flags and output, plus
``--device`` (default ``cuda``: without a card it exits 2 unless
``--device cpu``). Weights come from a seeded ``torch.Generator`` on the
device; ``--scale full`` runs the config at its published widths. Every
family the port's registry builds serves: the dense decoder, the MoE and
MLA decoders (qwen2-moe-a2.7b, deepseek-v2-lite-16b), RWKV-6 and Hymba.
The prompt is teacher-forced through decode steps, which run no kernel.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--scale", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: cuda; there is no "
                         "silent fallback to the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) needs an NVIDIA GPU, and "
              "torch finds no CUDA card here; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "reduced":
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    B = args.batch
    max_len = args.prompt_len + args.gen

    if cfg.stub_frontend:
        prompt = 0.02 * torch.randn((B, args.prompt_len, cfg.d_model),
                                    generator=gen, device=device)
    else:
        prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                               generator=gen, device=device)

    # --- prefill: teacher-force the prompt through decode steps to build
    # the cache (single-token path keeps one code path for all families).
    decode = make_serve_step(model)
    cache = model.init_cache(B, max_len, device=device)
    _sync(device)
    t0 = time.time()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = decode(params, cache, t, prompt[:, t:t + 1])
    _sync(device)
    prefill_s = time.time() - t0

    # --- batched greedy/temperature decode
    outs = []
    t0 = time.time()
    sample_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    for t in range(args.prompt_len, max_len):
        flat = logits.reshape(B, -1).to(torch.float32)
        if args.temperature > 0:
            probs = torch.softmax(flat / args.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=sample_gen)[:, 0]
        else:
            nxt = torch.argmax(flat, dim=-1)
        nxt = torch.clamp(nxt, 0, cfg.vocab_size - 1)
        outs.append(nxt)
        if cfg.stub_frontend:
            tok = 0.02 * torch.randn(
                (B, 1, cfg.d_model),
                generator=torch.Generator(device=device).manual_seed(t),
                device=device)
        else:
            tok = nxt[:, None]
        logits, cache = decode(params, cache, t, tok)
    _sync(device)
    decode_s = time.time() - t0

    tokens = torch.stack(outs, dim=1)
    print("generated token ids (first row):", tokens[0].tolist())
    print(json.dumps({
        "arch": args.arch,
        "prefill_s": round(prefill_s, 3),
        "decode_s": round(decode_s, 3),
        "decode_tok_per_s": round(B * args.gen / max(decode_s, 1e-9), 1),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

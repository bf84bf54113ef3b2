"""Batched LM serving on the port, the counterpart of
``examples/serve_batch.py``: a mixed queue of requests through
``repro_torch.runtime.serve.BatchedServer``.

``PYTHONPATH=src python -m benchmarks.pt_serve [--arch hymba-1.5b]
[--device cuda] [--layers N] [--seed 0]``

Builds the model at the config's full width (``--layers`` cuts the depth;
the default is the config's), draws its weights from a seeded
``torch.Generator``, submits :func:`request_mix` (two waves at
``max_batch=8``), drains the queue and prints requests, waves, decode
steps, tokens/s, prefill ms per wave, decode ms per step and each kernel's
launch count. Runs on the CUDA device unless ``--device`` names another;
without a card the default fails. Any architecture of the registry:
``--arch whisper-tiny`` (the encoder-decoder, zero frames, as the
reference's server gives them), ``--arch internvl2-76b --layers 8``
(the VLM, zero patches before each prompt), ``--arch phi3-mini-3.8b``
and ``--arch granite-20b`` (dense, full depth: 7.6 and 56.3 GB) or
``--arch kimi-k2-1t-a32b --layers 1`` (38.8 GB) too.

It also holds what the LM reference rows share between the JAX package
(``benchmarks/pt_jax_reference.py``) and the smoke run: the reference
configurations (hymba-1.5b, ``LM_REFERENCE``; grok-1, ``MOE_REFERENCE``;
phi3-mini, ``DENSE_REFERENCE``; whisper-tiny, ``ENCDEC_REFERENCE``) and
the per-step logit summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
from repro_torch.models.api import build_model
from repro_torch.models.layers import init_params
from repro_torch.runtime.serve import BatchedServer

# wave 1: greedy prompts of these lengths (the two 256s are one prompt)
WAVE1_LENGTHS = (1280, 1024, 768, 512, 256, 256, 128, 64)
WAVE2_LENGTH, WAVE2_N = 256, 4
NEW_TOKENS = 32
MAX_BATCH, MAX_SEQ = 8, 2048

# the LM reference rows: hymba at full width, 2 layers, float32; B prompts
# of S tokens (crossing the 1024 window), then teacher-forced greedy steps
LM_REFERENCE = dict(arch="hymba-1.5b", n_layers=2, dtype="float32",
                    batch=2, prompt_len=1280, decode_steps=8,
                    param_seed=0, prompt_seed=1, top_k=16, n_probe=64)
# the MoE reference rows: grok-1 at full width, 1 layer (6.53 B
# parameters, 26.1 GB in float32), 2 x 64 prompt tokens, 4 steps
MOE_REFERENCE = dict(LM_REFERENCE, arch="grok-1-314b", n_layers=1,
                     prompt_len=64, decode_steps=4)
# the dense rows: phi3-mini at full width, 2 layers (0.42 B parameters,
# 1.7 GB in float32), as LM_REFERENCE: D = 96, where hymba has 64
DENSE_REFERENCE = dict(LM_REFERENCE, arch="phi3-mini-3.8b")
# the encoder-decoder's rows: whisper-tiny at full width and depth (4 + 4
# layers), float32; 2 x 32 prompt tokens over 1,500 frames drawn from
# frame_seed, one decode step, and the loss on the prompts as labels
ENCDEC_REFERENCE = dict(LM_REFERENCE, arch="whisper-tiny", n_layers=4,
                        prompt_len=32, decode_steps=1, frame_seed=2)


def request_mix(vocab_size: int, seed: int = 0):
    """(prompt, max_new_tokens, temperature) of the twelve requests: eight
    greedy prompts (WAVE1_LENGTHS; the two 256-token prompts are the same,
    so determinism can be read), then four 256-token prompts, one at
    temperature 0.8 and one stopping after 8 tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for n in WAVE1_LENGTHS:
        if reqs and n == len(reqs[-1][0]):
            reqs.append((reqs[-1][0], NEW_TOKENS, 0.0))
        else:
            reqs.append((rng.integers(1, vocab_size, n, dtype=np.int32),
                         NEW_TOKENS, 0.0))
    for i in range(WAVE2_N):
        prompt = rng.integers(1, vocab_size, WAVE2_LENGTH, dtype=np.int32)
        reqs.append((prompt, 8 if i == 3 else NEW_TOKENS,
                     0.8 if i == 2 else 0.0))
    return reqs


def reference_config(r=LM_REFERENCE):
    """The ArchConfig of the LM reference rows ``r`` (port-side copy)."""
    return dataclasses.replace(get_config(r["arch"]), n_layers=r["n_layers"],
                               param_dtype=r["dtype"],
                               compute_dtype=r["dtype"], remat="none")


def reference_prompts(cfg, r=LM_REFERENCE) -> np.ndarray:
    return np.random.default_rng(r["prompt_seed"]).integers(
        0, cfg.vocab_size, (r["batch"], r["prompt_len"]), dtype=np.int32)


def reference_frames(cfg, r=ENCDEC_REFERENCE) -> np.ndarray:
    """The encoder-decoder rows' frames (B, F, d_model), standard normal
    float32."""
    return np.random.default_rng(r["frame_seed"]).standard_normal(
        (r["batch"], cfg.n_frontend_tokens, cfg.d_model), np.float32)


def probe_ids(cfg, r=LM_REFERENCE) -> np.ndarray:
    """The fixed vocabulary indices whose logits the reference keeps."""
    return np.sort(np.random.default_rng(r["prompt_seed"] + 1).choice(
        cfg.vocab_size, r["n_probe"], replace=False))


def logit_summary(logits: np.ndarray, probe: np.ndarray) -> list:
    """Per row of (B, V) float32 logits: the greedy token, its top-2
    margin, the top-k ids and logits, the logsumexp and the logits at
    ``probe``."""
    k = LM_REFERENCE["top_k"]
    out = []
    for row in np.asarray(logits, np.float64):
        top = np.argsort(-row, kind="stable")[:k]
        m = row.max()
        out.append({"token": int(top[0]),
                    "margin": float(row[top[0]] - row[top[1]]),
                    "top_ids": [int(i) for i in top],
                    "top_logits": [float(row[i]) for i in top],
                    "logsumexp": float(m + np.log(np.exp(row - m).sum())),
                    "probe_logits": [float(row[i]) for i in probe]})
    return out


def reference_errors(logits: np.ndarray, want: list, probe: np.ndarray,
                     tol: float) -> dict:
    """(B, V) logits held to one step's reference rows: the largest
    absolute error over the logits at the reference's top-k ids and probe
    ids and over the logsumexp, and the rows whose greedy token differs
    although the reference's top-2 margin exceeds 10 x ``tol``."""
    got = logit_summary(logits, probe)
    err, mismatch = 0.0, []
    for i, (g, w, row) in enumerate(zip(got, want, np.asarray(logits))):
        err = max(err, float(np.abs(row[w["top_ids"]]
                                    - np.array(w["top_logits"])).max()),
                  float(np.abs(np.array(g["probe_logits"])
                               - np.array(w["probe_logits"])).max()),
                  abs(g["logsumexp"] - w["logsumexp"]))
        if w["margin"] > 10 * tol and g["token"] != w["token"]:
            mismatch.append(i)
    return {"max_abs_err": err, "greedy_mismatch": mismatch}


def serve(cfg, device, seed: int = 0):
    """Build the model on ``device`` in the config's types, draw its
    weights from ``seed``, run the request mix; returns (server, model)."""
    device = torch.device(device)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model.load_params(init_params(cfg, gen, None, device))
    server = BatchedServer(model, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                           seed=seed)
    for prompt, n, temp in request_mix(cfg.vocab_size, seed):
        server.submit(prompt, max_new_tokens=n, temperature=temp)
    server.run_until_drained()
    return server, model


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="hymba-1.5b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to this many layers (0: the config's)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the "
                         "CPU")
    fa.launches = ss.launches = 0
    t0 = time.time()
    server, _ = serve(cfg, device, seed=args.seed)
    st = server.stats
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_dtype}, on {name} ({time.time() - t0:.1f}s with "
          "set-up)")
    print(f"requests {st.requests_done}, waves {st.waves}, decode steps "
          f"{st.decode_steps}, tokens {st.tokens_generated}, "
          f"{st.tokens_per_s:.1f} tokens/s")
    for r in server.done:
        print(f"  request {r.uid}: prompt {len(r.prompt)}, "
              f"{len(r.tokens)} tokens ({r.finish_reason})")
    for w, (pre, dec, calls) in enumerate(zip(st.prefill_s, st.decode_s,
                                              st.decode_calls)):
        print(f"wave {w + 1}: prefill {1e3 * pre:.1f} ms, {calls} decode "
              f"steps at {1e3 * dec / max(calls, 1):.2f} ms")
    print(f"launches: flash_attention {fa.launches}, fused_selective_scan "
          f"{ss.launches}; non-finite logits {st.nonfinite_logits}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

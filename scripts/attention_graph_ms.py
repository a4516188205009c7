#!/usr/bin/env python3
"""K5's and K5b's device time at the main path's shapes, for one checkout.

    python3 scripts/attention_graph_ms.py [ROOT]

Builds the two attention libraries of the checkout at ``ROOT`` (default: this
one) and prints one JSON line: ``chip_smoke.graph_ms`` (24 calls replayed as
one CUDA graph, median of 10) of K5 at Mistral-Nemo-12B's largest prefill (q
1 x 1963 x 32 x 128, k/v 1 x 1963 x 8 x 128, bf16, causal) and of K5b at
granite-moe-3b-a800m's and Mistral-Nemo-12B's training shapes, each without a
query offset.  To compare two versions of the kernels, unpack the other
commit into a git-ignored directory (``git archive``) and run both in one
call on one card, in turns: other, this, this, other.
"""

import json
import sys
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path[:0] = [str(root / "src"), str(root)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("attention_graph_ms: no CUDA device is available")
build.build_kernels(["flash_attention", "flash_attention_bwd"])
gen = torch.Generator(device="cuda").manual_seed(0)
bf = torch.bfloat16
q = cs.randn(torch, gen, (1, 1963, 32, 128), bf, cs.QK_SCALE)
k = cs.randn(torch, gen, (1, 1963, 8, 128), bf, cs.QK_SCALE)
v = cs.randn(torch, gen, (1, 1963, 8, 128), bf)
out = {"tree": str(root), "card": cs.smi_line(), "k5": cs.graph_ms(lambda: fa.flash_attention(q, k, v, causal=True))}
for name, (b, t, h, kv, d) in {"k5b_granite": (4, 2048, 24, 8, 64), "k5b_mistral": (2, 2048, 32, 8, 128)}.items():
    q = cs.randn(torch, gen, (b, t, h, d), bf, cs.QK_SCALE)
    k = cs.randn(torch, gen, (b, t, kv, d), bf, cs.QK_SCALE)
    v = cs.randn(torch, gen, (b, t, kv, d), bf)
    do = cs.randn(torch, gen, (b, t, h, d), bf)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    out[name] = cs.graph_ms(lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True))
print(json.dumps(out), flush=True)

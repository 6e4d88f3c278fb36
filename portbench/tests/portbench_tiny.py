"""Tiny configurations and mixes that put a cell on the CPU (the tests' overrides)."""

import json
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]


def _as_run(name):
    return {**json.loads((HERE / "configs" / f"{name}.json").read_text())["as_run"], "dtype": "float32"}


MOE = {"family": "moe", "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128, "num_local_experts": 4,
       "num_experts_per_tok": 2, "vocab_size": 256, "rope_theta": 10000.0,
       "as_run": _as_run("phi35moe-16of32"),
       "port": {"arch": "phi3.5-moe-42b-a6.6b",
                "options": {"num_layers": 2, "moe_dispatch": "merge_path_pallas", "d_model": 64, "num_heads": 4,
                            "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "num_experts": 4, "vocab_size": 256,
                            "dtype": "float32"}}}
SSM = {"family": "ssm", "hidden_size": 64, "num_hidden_layers": 2, "intermediate_size": 128, "state_size": 8,
       "conv_kernel": 4,
       "time_step_rank": 4, "vocab_size": 256, "as_run": _as_run("falconmamba7b-16of64"),
       "port": {"arch": "falcon-mamba-7b",
                "options": {"num_layers": 2, "ssm_backend": "fused", "d_model": 64, "vocab_size": 256, "ssm_state": 8,
                            "dtype": "float32", "ssm_chunk": 8}}}
PREFILL_MIX = {"median": 24, "min": 8, "max": 48, "quantiles": 8}
TRAIN_MIX = {"row": 48, "rows": 4, "mean": 10, "min": 2, "max": 48}


def run(cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.3, trace: bool = False, **kw) -> harness.Run:
    ov = {"config": MOE if cell.startswith("phi") else SSM,
          "mix": PREFILL_MIX if "prefill" in cell else TRAIN_MIX}
    return harness.Run(cell, seed, seconds, trace, device="cpu", overrides=ov, **kw)

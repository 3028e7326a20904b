"""Eval & calibration harness (the port of ``mobius_rag_tpu.eval_harness``).

Consumes the reference's YAML query banks unchanged (eval/queries_cmhc*.yaml,
queries_gate_contours.yaml, pointed at by Config.eval_bank_dir) plus the
port's JSON copies of the JAX package's banks (toy, cmhc_paraphrase).
"""
from mobius_rag_tpu_torch.eval_harness.bank import Bank, load_bank  # noqa: F401
from mobius_rag_tpu_torch.eval_harness.fact_checker import check_facts  # noqa: F401
from mobius_rag_tpu_torch.eval_harness.judge import judge_answer  # noqa: F401

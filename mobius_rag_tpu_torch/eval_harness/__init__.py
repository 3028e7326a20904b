"""Eval & calibration harness (the port of ``mobius_rag_tpu.eval_harness``).

Only the eval DB (``db.py``) is ported so far; the bank loader, the
runners, the fact checker and the judge follow (ROADMAP queue 1, item 6).
"""

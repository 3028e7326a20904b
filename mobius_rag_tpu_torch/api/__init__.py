from mobius_rag_tpu_torch.api.server import AppContext, build_app  # noqa: F401

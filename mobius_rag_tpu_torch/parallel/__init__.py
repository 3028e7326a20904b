from mobius_rag_tpu_torch.parallel.mesh import (Mesh, make_mesh, make_serve_mesh,  # noqa: F401
                                                make_train_mesh)
from mobius_rag_tpu_torch.parallel.sharded import ShardedEngine  # noqa: F401

"""fleet — the hybrid-parallel orchestration API.

Port of ``paddle_tpu/distributed/fleet.py`` (reference:
``fleet/fleet.py:218``, ``fleet/model.py:142-174``). ``init`` builds
the global hybrid mesh from ``strategy.hybrid_configs`` over the
process group (``init_parallel_env`` first when it is not joined);
``distributed_model`` wraps a model for pure data parallelism in
``DataParallel`` (tensor-parallel models carry their ``mpu`` layers);
``distributed_optimizer`` shards the optimizer's state when the
strategy asks for sharding.
"""
from __future__ import annotations

from typing import Optional

from ..parallel.mesh import HybridMesh, get_hybrid_mesh, init_hybrid_mesh
from .env import get_rank, get_world_size, init_parallel_env

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker",
           "barrier_worker"]


class DistributedStrategy:
    """Reference: ``fleet/base/distributed_strategy.py``. The knobs the
    port acts on are ``hybrid_configs`` and ``sharding_configs``
    (``"stage"``); other attributes are accepted and kept."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1, "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}


_state = {"strategy": None}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         device=None):
    """Join the process group (``device`` as ``init_parallel_env``) and
    build the hybrid mesh: dp = dp_degree x sharding_degree, tp =
    mp_degree, pp, cp = sep_degree, ep; all degrees 1 means data
    parallel over the whole world."""
    strategy = strategy or DistributedStrategy()
    init_parallel_env(device=device)
    hc = strategy.hybrid_configs
    dp = int(hc.get("dp_degree", 1)) * int(hc.get("sharding_degree", 1))
    tp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    cp = int(hc.get("sep_degree", 1))
    ep = int(hc.get("ep_degree", 1))
    n = get_world_size()
    need = dp * tp * pp * cp * ep
    if need > n:
        raise ValueError(
            f"hybrid degrees dp{dp}*pp{pp}*cp{cp}*ep{ep}*tp{tp} exceed "
            f"{n} ranks")
    if need == 1:
        dp = n
    init_hybrid_mesh(dp=dp, pp=pp, tp=tp, ep=ep, cp=cp)
    _state["strategy"] = strategy
    return get_hybrid_mesh()


def _require_init():
    if _state["strategy"] is None:
        raise RuntimeError("call fleet.init() first")


def distributed_model(model):
    """``DataParallel(model)`` when the mesh is data parallel only;
    otherwise the model as it is (its ``mpu`` layers carry tp)."""
    _require_init()
    hm = get_hybrid_mesh()
    if hm.dp_degree > 1 and hm.world_size == hm.dp_degree:
        from .parallel import DataParallel
        return DataParallel(model)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer, state-sharded over dp (``sharding_configs``'s
    ``"stage"``, 1 by default) when the strategy's ``sharding`` is on or
    its ``sharding_degree`` above 1."""
    _require_init()
    strategy = strategy or _state["strategy"]
    if strategy.sharding or \
            int(strategy.hybrid_configs.get("sharding_degree", 1)) > 1:
        from .sharding import ShardedOptimizer
        return ShardedOptimizer(optimizer,
                                strategy.sharding_configs.get("stage", 1))
    return optimizer


def get_hybrid_communicate_group() -> Optional[HybridMesh]:
    return get_hybrid_mesh()


def worker_num() -> int:
    return get_world_size()


def worker_index() -> int:
    return get_rank()


def is_first_worker() -> bool:
    return get_rank() == 0


def barrier_worker():
    from .communication import barrier
    barrier()

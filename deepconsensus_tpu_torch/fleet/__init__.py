"""Fleet tier: `route` load balancing and disaggregated featurize (port
of deepconsensus_tpu/fleet, without its autoscaler).

One resident `serve` replica owns one card; fleet scale is N of them
behind a router, with the CPU-heavy BAM decode and pileup moved out to
featurize workers, so the replicas run nothing but the model.

  registry.py          health-gated replica registration and probing
  balancer.py          weighted least-loaded pick, bounded in-flight,
                       weighted-fair multi-tenant admission
  router.py            `route`: the /v1/polish front tier
  featurize_worker.py  `featurize-worker`: bam/1 -> features/1

Nothing here imports torch.
"""
from deepconsensus_tpu_torch.fleet.registry import (  # noqa: F401
    FEATURIZE_TIER,
    MODEL_TIER,
    Replica,
    ReplicaRegistry,
    ReplicaState,
)
from deepconsensus_tpu_torch.fleet.balancer import (  # noqa: F401
    LeastLoadedBalancer,
)

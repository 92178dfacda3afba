"""FaaSTube core, PyTorch port: GPU-oriented inter-function data passing.

Public surface (the simulator and policy layers are copies of the JAX
package's framework-free modules; the real data plane is
``backend_torch.TorchBackend``):
    FaaSTube (api.py)           — unique_id / store / fetch (policy facade)
    TransferEngine (transfer.py)— TransferPlan compilation + execution
    Topology (topology.py)      — DGX-V100 / DGX-A100 / 4xA10 / TPU torus
    PathFinder (pathfinder.py)  — Alg. 1 contention-aware parallel paths
    LinkSim (linksim.py)        — discrete-event link timing model
    ElasticPool (elastic_pool.py), QueueAwareMigrator (migration.py)
    PcieScheduler (pcie_scheduler.py), CircularPinnedBuffer (pinned_buffer.py)
    FaultSchedule / FaultInjector (faults.py)
                                — seeded deterministic chaos harness
    ShardedLinkSim / ShardedTube (shard.py)
                                — the simulator sharded by node (CPU only:
                                  parallel mode forks worker processes)
    TorchBackend (backend_torch.py)
                                — real bytes on the card: slab stores in
                                  device memory, page-locked host staging,
                                  hand-written CUDA gather/scatter kernels
"""
from repro_torch.core.topology import Topology, make_topology
from repro_torch.core.pathfinder import PathFinder
from repro_torch.core.linksim import LinkSim
from repro_torch.core.transfer import TransferEngine, TransferPlan, RecoveryPolicy
from repro_torch.core.faults import Fault, FaultInjector, FaultSchedule

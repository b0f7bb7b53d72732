# P/D-Serve core: the paper's contribution as a composable system
# (counterpart of src/repro/core/__init__.py).
#
#   perf_model    — E2E model (Phi, T_p, T_d) + Eq.1 ratio optimizer
#   requests      — scenario-structured workload (shared prefixes, tidal)
#   prefix_cache  — HBM-budgeted prefix-KVCache placement (C1)
#   profiles      — serving cost profiles (H100 roofline or measured)
#   zookeeper     — service/scenario/group/RoCE metadata store
#   group         — fine-grained P/D groups, dynamic RoCE workflows (C1)
#   mlops         — health, minimum-cost recovery, scaling, ratio control
#   cluster_sim   — discrete-event cluster simulator (gateway policies, C2)
#   aggregated    — the aggregated-serving baseline simulator
#   regions       — multi-region routing and failover (§3.7)
#   transfer      — block-free D2D KVCache transfer engine (C3)
from repro_torch.core import (aggregated, cluster_sim, group,  # noqa: F401
                              mlops, perf_model, prefix_cache, profiles,
                              regions, requests, transfer, zookeeper)

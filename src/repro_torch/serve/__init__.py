"""repro_torch.serve — continuous-batching serving tier on baked LiLAC
plans (counterpart of ``repro.serve``).

Public surface::

    from repro_torch.serve import (Engine, ServeConfig, build_engine,
                                   FrontDoor, build_fleet, default_replicas,
                                   Scheduler, Request, SchedulerFull,
                                   BucketPolicy, BucketError, parse_buckets,
                                   default_buckets,
                                   ServeMetrics, percentiles,
                                   latency_histogram, SyntheticWorkload)

The reference's ``docs/serving.md`` describes the scheduler lifecycle, the
bucket/prewarm semantics, the multi-replica front door and the metrics
schema; ``repro_torch.serve.engine`` says where the port differs.
"""
from repro_torch.serve.buckets import (BucketError, BucketPolicy,
                                       default_buckets, parse_buckets)
from repro_torch.serve.engine import Engine, ServeConfig, build_engine
from repro_torch.serve.frontdoor import FrontDoor, build_fleet, \
    default_replicas
from repro_torch.serve.metrics import (ServeMetrics, latency_histogram,
                                       percentiles)
from repro_torch.serve.packing import (moe_ffn_padded, moe_ffn_ragged, pack,
                                       padding_waste, unpack)
from repro_torch.serve.scheduler import Request, Scheduler, SchedulerFull
from repro_torch.serve.workload import SyntheticWorkload

__all__ = [
    "BucketError", "BucketPolicy", "default_buckets", "parse_buckets",
    "Engine", "ServeConfig", "build_engine",
    "FrontDoor", "build_fleet", "default_replicas",
    "ServeMetrics", "latency_histogram", "percentiles",
    "moe_ffn_padded", "moe_ffn_ragged", "pack", "padding_waste", "unpack",
    "Request", "Scheduler", "SchedulerFull",
    "SyntheticWorkload",
]

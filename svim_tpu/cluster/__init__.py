"""CLUSTER stage: partition signatures and merge them into clusters.

Reference semantics: svim/SVIM_clustering.py, svim/SVIM_CLUSTER.py.
Host path here is the exactness oracle; the batched device distance kernels live
in svim_tpu.ops and are wired in through svim_tpu.cluster.accel.
"""

from svim_tpu.cluster.cluster import (
    cluster_sv_signatures,
    partition_and_cluster,
    partition_and_cluster_candidates,
)
from svim_tpu.cluster.partition import form_partitions

__all__ = [
    "cluster_sv_signatures",
    "partition_and_cluster",
    "partition_and_cluster_candidates",
    "form_partitions",
]

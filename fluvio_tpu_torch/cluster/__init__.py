"""Cluster tooling of the port: the local preflight checks
(`check.ClusterChecker`). The JAX package's local-cluster runner, its K8s
installer and its status and delete commands are not carried."""

from fluvio_tpu_torch.cluster.check import CheckResult, ClusterChecker

__all__ = ["CheckResult", "ClusterChecker"]

"""Client profile configuration (the port's copy of
``fluvio_tpu/client/config.py``).

Capability parity: fluvio/src/config/{config.rs,cluster.rs,tls.rs} — the
``~/.fluvio/config`` file holding named clusters (endpoint + TLS policy),
named profiles pointing at clusters, and the current-profile switch the
CLI mutates. Stored at ``~/.fluvio-tpu/config`` (the reference uses TOML;
the schema is the same); the path is an argument, and no environment
variable overrides it. The port writes the file as JSON text through
`metadata/yaml_subset.py` (the JAX package's ``yaml.safe_load`` reads
it) and reads both that and the block YAML the JAX package writes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from fluvio_tpu_torch.metadata import yaml_subset

DEFAULT_CONFIG_DIR = "~/.fluvio-tpu"


class ConfigError(Exception):
    pass


@dataclass
class TlsPolicy:
    """Disabled / anonymous / verified TLS (parity: config/tls.rs).

    ``verified`` carries cert material as file paths; ``domain`` is the
    SNI/verification name. The transport layer consumes this when TLS is
    enabled (local clusters run plaintext, like the reference's default).
    """

    mode: str = "disabled"  # disabled | anonymous | verified
    domain: str = ""
    ca_cert: str = ""
    client_cert: str = ""
    client_key: str = ""

    def to_dict(self) -> dict:
        if self.mode == "disabled":
            return {"mode": "disabled"}
        d = {"mode": self.mode, "domain": self.domain}
        if self.mode == "verified":
            d.update(
                ca_cert=self.ca_cert,
                client_cert=self.client_cert,
                client_key=self.client_key,
            )
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TlsPolicy":
        if not d:
            return cls()
        return cls(
            mode=d.get("mode", "disabled"),
            domain=d.get("domain", ""),
            ca_cert=d.get("ca_cert", ""),
            client_cert=d.get("client_cert", ""),
            client_key=d.get("client_key", ""),
        )


@dataclass
class FluvioClusterConfig:
    """One cluster entry: SC public endpoint + TLS (parity: cluster.rs)."""

    endpoint: str = ""
    tls: TlsPolicy = field(default_factory=TlsPolicy)

    def to_dict(self) -> dict:
        return {"endpoint": self.endpoint, "tls": self.tls.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "FluvioClusterConfig":
        return cls(
            endpoint=d.get("endpoint", ""),
            tls=TlsPolicy.from_dict(d.get("tls")),
        )


@dataclass
class Profile:
    cluster: str = ""

    def to_dict(self) -> dict:
        return {"cluster": self.cluster}

    @classmethod
    def from_dict(cls, d: dict) -> "Profile":
        return cls(cluster=d.get("cluster", ""))


@dataclass
class Config:
    """The whole config document (parity: config.rs `Config`)."""

    version: str = "2.0"
    current_profile: Optional[str] = None
    profiles: Dict[str, Profile] = field(default_factory=dict)
    clusters: Dict[str, FluvioClusterConfig] = field(default_factory=dict)

    # -- profile switching --------------------------------------------------

    def current_profile_name(self) -> str:
        if not self.current_profile or self.current_profile not in self.profiles:
            raise ConfigError("no current profile set (run `profile use <name>`)")
        return self.current_profile

    def current_cluster(self) -> FluvioClusterConfig:
        profile = self.profiles[self.current_profile_name()]
        cluster = self.clusters.get(profile.cluster)
        if cluster is None:
            raise ConfigError(
                f"profile {self.current_profile!r} points at unknown "
                f"cluster {profile.cluster!r}"
            )
        return cluster

    def add_cluster(
        self, name: str, cluster: FluvioClusterConfig, make_current: bool = True
    ) -> None:
        """Register a cluster + same-named profile (cluster-start flow)."""
        self.clusters[name] = cluster
        self.profiles[name] = Profile(cluster=name)
        if make_current or self.current_profile is None:
            self.current_profile = name

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "current_profile": self.current_profile,
            "profiles": {k: v.to_dict() for k, v in self.profiles.items()},
            "clusters": {k: v.to_dict() for k, v in self.clusters.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            version=str(d.get("version", "2.0")),
            current_profile=d.get("current_profile"),
            profiles={
                k: Profile.from_dict(v) for k, v in (d.get("profiles") or {}).items()
            },
            clusters={
                k: FluvioClusterConfig.from_dict(v)
                for k, v in (d.get("clusters") or {}).items()
            },
        )


class ConfigFile:
    """Load/mutate/save the profile file (parity: config.rs ConfigFile)."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path or default_config_path())
        self.config = Config()

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ConfigFile":
        cf = cls(path)
        if cf.path.exists():
            data = yaml_subset.loads(cf.path.read_text(encoding="utf-8")) or {}
            cf.config = Config.from_dict(data)
        return cf

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(yaml_subset.dumps(self.config.to_dict()), encoding="utf-8")
        os.replace(tmp, self.path)


def default_config_path() -> str:
    return str(Path(DEFAULT_CONFIG_DIR).expanduser() / "config")


def current_cluster(path: Optional[str] = None) -> FluvioClusterConfig:
    """The active profile's cluster entry (endpoint + TLS policy)."""
    cf = ConfigFile.load(path)
    return cf.config.current_cluster()

"""Client entry point (the port's copy of ``fluvio_tpu/client/fluvio.py``;
parity: fluvio/src/fluvio.rs `Fluvio::connect`).

Two modes, told apart by the api keys the endpoint advertises:

- **SC mode**: dial the SC's public endpoint, start the client-side
  metadata mirror (admin watch streams), and route each topic and
  partition to its leader SPU's public address (spu.rs:97).
- **Lone-SPU mode**: dial one SPU's public endpoint; the pool is that one
  connection.

With no address, `Fluvio.connect` takes the active profile's endpoint and
TLS policy from the profile file (`client/config.py`,
``~/.fluvio-tpu/config`` unless ``config_path`` names another). The TLS
policy applies to the SC, every SPU dial and the admin client.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from fluvio_tpu_torch.client.admin import FluvioAdmin
from fluvio_tpu_torch.client.config import current_cluster
from fluvio_tpu_torch.client.consumer import (
    MultiplePartitionConsumer,
    PartitionConsumer,
    PartitionSelectionStrategy,
)
from fluvio_tpu_torch.client.producer import (
    ProducerConfig,
    TopicProducer,
    resolve_topic_compression,
)
from fluvio_tpu_torch.client.sync import MetadataStores
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.schema.admin import AdminApiKey
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket


class SpuPool:
    """Leader-routed socket cache (parity: fluvio/src/spu.rs:97,152)."""

    def __init__(
        self,
        default_addr: Optional[str] = None,
        metadata: Optional[MetadataStores] = None,
        tls=None,
    ):
        self._default_addr = default_addr
        self._metadata = metadata
        self._tls = tls  # the client TlsPolicy of every SPU dial
        self._sockets: Dict[str, VersionedSerialSocket] = {}

    async def addr_for(self, topic: str, partition: int) -> str:
        if self._metadata is not None:
            addr = await self._metadata.wait_for_leader(topic, partition)
            if addr is not None:
                return addr
        if self._default_addr is None:
            raise ConnectionError(
                f"no leader known for {topic}-{partition} and no default SPU"
            )
        return self._default_addr

    async def socket_for(self, topic: str, partition: int) -> VersionedSerialSocket:
        """Connect to the partition leader, re-resolving on failure: the
        metadata mirror can lag the SC's election for a moment, so a
        refused connection to an old leader is retried against the freshly
        resolved address."""
        last_err: Exception | None = None
        for attempt in range(6):
            addr = await self.addr_for(topic, partition)
            sock = self._sockets.get(addr)
            if sock is not None and not sock.is_stale:
                return sock
            try:
                sock = await VersionedSerialSocket.connect(addr, tls=self._tls)
                self._sockets[addr] = sock
                return sock
            except OSError as e:
                last_err = e
                self._sockets.pop(addr, None)
                if self._metadata is None:
                    raise
                await asyncio.sleep(0.1 * (attempt + 1))
        raise ConnectionError(
            f"no reachable leader for {topic}-{partition}"
        ) from last_err

    async def close(self) -> None:
        for sock in self._sockets.values():
            await sock.close()
        self._sockets.clear()


class Fluvio:
    def __init__(
        self,
        pool: SpuPool,
        metadata: Optional[MetadataStores] = None,
        sc_socket: Optional[VersionedSerialSocket] = None,
        sc_addr: Optional[str] = None,
        tls=None,
    ):
        self._pool = pool
        self._metadata = metadata
        self._sc_socket = sc_socket
        self._sc_addr = sc_addr
        self._tls = tls

    @classmethod
    async def connect(
        cls, addr: Optional[str] = None, tls=None, config_path: Optional[str] = None
    ) -> "Fluvio":
        """Connect to a cluster at ``host:port``: an SC's public endpoint
        or a lone SPU. With no address, the active profile's endpoint and,
        unless ``tls`` is given, its TLS policy (parity: Fluvio::connect ->
        ConfigFile, fluvio.rs:56)."""
        if addr is None:
            cluster = current_cluster(config_path)
            addr = cluster.endpoint
            if tls is None and cluster.tls.mode != "disabled":
                tls = cluster.tls
        socket = await VersionedSerialSocket.connect(addr, tls=tls)
        if socket.versions.lookup_version(AdminApiKey.CREATE) is not None:
            metadata = MetadataStores(socket)
            await metadata.start()
            return cls(
                SpuPool(metadata=metadata, tls=tls),
                metadata=metadata,
                sc_socket=socket,
                sc_addr=addr,
                tls=tls,
            )
        await socket.close()
        pool = SpuPool(default_addr=addr, tls=tls)
        await pool.socket_for("", 0)  # eager validation + version negotiation
        return cls(pool)

    @property
    def metadata(self) -> Optional[MetadataStores]:
        return self._metadata

    async def admin(self) -> FluvioAdmin:
        if self._sc_addr is None:
            raise RuntimeError("admin API requires an SC connection")
        return await FluvioAdmin.connect(self._sc_addr, tls=self._tls)

    async def topic_producer(
        self,
        topic: str,
        num_partitions: Optional[int] = None,
        config: Optional[ProducerConfig] = None,
    ) -> TopicProducer:
        # resolve the topic spec once: it carries both the partition
        # count (default num_partitions) and the compression policy.
        # Peek the watch mirror, then ask the SC store: one round trip on
        # the open SC socket settles present-vs-absent without racing the
        # mirror after a create
        tobj = None
        if self._metadata is not None:
            tobj = self._metadata.topics.store.value(topic)
            if tobj is None:
                listed = await self._metadata.list(TopicSpec.KIND, [topic])
                tobj = listed[0] if listed else None
                if tobj is None and num_partitions is None:
                    raise ValueError(f"unknown topic {topic!r}")
        spec = tobj.spec if tobj is not None else None
        if num_partitions is None:
            if tobj is not None:
                # provisioned count (status) over the spec's request: a
                # topic mid-provisioning must not route to leaderless
                # partitions
                num_partitions = MetadataStores.count_from_topic_object(tobj)
            else:
                num_partitions = 1  # lone-SPU connection: no metadata
        if spec is not None:
            config = resolve_topic_compression(spec.compression_type, config)

        async def socket_factory(partition: int = 0):
            return await self._pool.socket_for(topic, partition)

        return TopicProducer(topic, num_partitions, socket_factory, config)

    async def partition_consumer(self, topic: str, partition: int = 0) -> PartitionConsumer:
        socket = await self._pool.socket_for(topic, partition)
        return PartitionConsumer(topic, partition, socket)

    async def consumer(self, strategy: PartitionSelectionStrategy) -> MultiplePartitionConsumer:
        """Multi-partition consumer from a `PartitionSelectionStrategy`
        (parity: Fluvio::consumer, consumer.rs:590-720). ``all`` resolves
        the partition set from the cluster metadata mirror (a lone-SPU
        connection has no metadata: pass explicit partitions instead)."""
        partitions = strategy.partitions
        if partitions is None:
            if self._metadata is None:
                raise ValueError(
                    "PartitionSelectionStrategy.all needs an SC connection; "
                    "use .multiple() with explicit partitions on a lone SPU"
                )
            count = await self._metadata.wait_partition_count(strategy.topic)
            if count is None:
                raise ValueError(f"unknown topic {strategy.topic!r}")
            partitions = list(range(count))
        consumers = [
            await self.partition_consumer(strategy.topic, p) for p in partitions
        ]
        return MultiplePartitionConsumer(consumers)

    async def close(self) -> None:
        if self._metadata is not None:
            await self._metadata.stop()
        await self._pool.close()
        if self._sc_socket is not None:
            await self._sc_socket.close()

"""Helper: replies to other authorities' sync requests.

Parity target: reference ``Helper`` (consensus/src/helper.rs:14-68): for
each (missing-digest, origin) request, read the block from the store and —
if we have it — send it back to the requester as a regular Propose
message, letting the normal proposal path store it and wake the
requester's parked synchronizer waiter.
"""

from __future__ import annotations

import asyncio
import logging

from ..network import SimpleSender
from ..store import Store
from .config import Committee
from .messages import Block
from .wire import encode_propose

log = logging.getLogger(__name__)


class Helper:
    def __init__(
        self,
        committee: Committee,
        store: Store,
        rx_requests: asyncio.Queue,
        network: SimpleSender | None = None,
        telemetry=None,
    ):
        self.committee = committee
        self.store = store
        self.rx_requests = rx_requests
        self.network = network if network is not None else SimpleSender()
        self._journal = telemetry.journal if telemetry is not None else None
        self._task: asyncio.Task | None = None

    async def run(self) -> None:
        while True:
            digest, origin = await self.rx_requests.get()
            address = self.committee.address(origin)
            if address is None:
                log.warning(
                    "Received sync request from unknown authority: %s", origin
                )
                continue
            data = await self.store.read(digest.to_bytes())
            if data is not None:
                block = Block.deserialize(data)
                if self._journal is not None:
                    self._journal.record(
                        "sync.reply", block.round, digest, str(origin)[:8]
                    )
                await self.network.send(address, encode_propose(block))

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name="helper"
        )
        return self._task

    def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.network.close()

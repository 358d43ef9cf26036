"""retrieve_transactions, the RAG tool (own copy of the JAX package's
``tools/retrieval.py``).

Behaviour of the reference tool (``tools/qdrant_tool.py:75-177``), with
the embedding and the search on the device:

- Security: an empty ``user_id`` gives ``[]`` at once; the index query
  carries a must-filter on ``metadata.user_id`` and every hit is checked
  again afterwards, skipped hits counted and logged.
- ``num_transactions`` defaults to 10,000 when unset; ``time_period_days``
  becomes ``metadata.date >= now - N days``.
- Returns ``page_content`` strings only; any exception gives ``[]`` with an
  error log.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher
from finchat_tpu_torch.embed.encoder import EmbeddingEncoder
from finchat_tpu_torch.embed.index import DeviceVectorIndex, QuerySpec
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, Timer

logger = get_logger(__name__)

DEFAULT_LIMIT = 10_000
DEFAULT_QUERY = "recent transactions"


class TransactionRetriever:
    """Callable tool: validated args dict (``user_id`` already injected
    server-side by the agent) → list of transaction texts.

    With a ``batcher`` (EmbedMicrobatcher) wired, the query embed
    coalesces with concurrent requests' embeds into shared device
    dispatches and the index search rides the batched device-filter
    plane (``query_points_batch``); without one, the serial host path is
    used unchanged. Per-stage latency lands in the
    ``finchat_retrieval_embed_seconds`` / ``finchat_retrieval_search_seconds``
    histograms either way (the graft stage is timed at the generator's
    ``extend_prompt`` seam)."""

    def __init__(
        self,
        encoder: EmbeddingEncoder,
        index: DeviceVectorIndex,
        *,
        default_limit: int = DEFAULT_LIMIT,  # VectorConfig.default_limit
        now: Callable[[], float] = time.time,
        batcher: EmbedMicrobatcher | None = None,
    ):
        self.encoder = encoder
        self.index = index
        self.default_limit = default_limit
        self.now = now
        self.batcher = batcher

    async def __call__(self, args: dict[str, Any]) -> list[str]:
        return [row["page_content"] for row in await self.structured(args)]

    async def structured(self, args: dict[str, Any]) -> list[dict[str, Any]]:
        """Like ``__call__`` but returns full rows (page_content + metadata
        fields): the data source for ``create_financial_plot``, which needs
        structured x/y fields, not rendered text.

        The embedding forward pass and the index query run device work and
        host syncs; they execute in a worker thread (like the ingestion
        path, serve/app.py), so in-flight token streams on the event loop
        never stall behind a retrieval. The batched plane keeps that
        property: the microbatcher dispatches in its own worker thread and
        the index query threads off explicitly."""
        import asyncio

        if self.batcher is None or not hasattr(self.index, "query_points_batch"):
            return await asyncio.to_thread(self._structured_sync, args)
        try:
            parsed = self._parse_args(args)
            if parsed is None:
                return []
            search_query, limit, date_gte = parsed
            user_id = args["user_id"]

            with Timer(METRICS, "finchat_retrieval_embed_seconds"):
                query_vector = await self.batcher.embed_one(search_query)
            with Timer(METRICS, "finchat_retrieval_search_seconds"):
                hits = (await asyncio.to_thread(
                    self.index.query_points_batch,
                    [QuerySpec(query_vector, limit=limit,
                               user_id=user_id, date_gte=date_gte)],
                ))[0]
            rows = self._secure_rows(hits, user_id)
            METRICS.inc("finchat_retrievals_total")
            logger.info("Successfully processed %d transactions", len(rows))
            return rows
        except Exception as e:
            logger.error("Error retrieving transactions: %s", e, exc_info=True)
            return []

    def _parse_args(self, args: dict[str, Any]) -> tuple[str, int, float | None] | None:
        """Shared tool-argument parsing for both retrieval planes: the
        user_id security gate (qdrant_tool.py:89-91), the search-query and
        limit defaults (:145), and the ``time_period_days`` → ``date >=``
        window (:116-126). ONE implementation, so the defaulting rules can
        never drift between the serial fallback and the batched plane.
        Returns ``(search_query, limit, date_gte)`` or None (refuse)."""
        user_id = args.get("user_id", "")
        logger.info("Starting transaction retrieval for user_id: %s", user_id)
        if not user_id:
            logger.error("Security violation: user_id not provided")
            return None
        search_query = args.get("search_query") or DEFAULT_QUERY
        limit = int(args.get("num_transactions") or self.default_limit)
        date_gte = None
        days = args.get("time_period_days")
        if days:
            date_gte = self.now() - days * 86_400.0
        return search_query, limit, date_gte

    def _secure_rows(self, hits, user_id: str) -> list[dict[str, Any]]:
        """The post-hoc security re-check (parity with
        qdrant_tool.py:159-170) — ONE implementation shared by the serial
        and batched planes, so the golden-equivalence contract between
        them covers the must-filter backstop too."""
        rows: list[dict[str, Any]] = []
        skipped = 0
        for hit in hits:
            payload = hit.payload
            metadata = hit.metadata
            if payload and metadata.get("user_id") == user_id:
                rows.append({**metadata, "page_content": payload["page_content"]})
            else:
                skipped += 1
                logger.warning(
                    "Security check: Skipping transaction with mismatched user_id. "
                    "Expected: %s, Got: %s", user_id, metadata.get("user_id"),
                )
        if skipped:
            logger.warning("Skipped %d transactions due to user_id mismatch", skipped)
            METRICS.inc("finchat_retrieval_security_skips_total", skipped)
        return rows

    def _structured_sync(self, args: dict[str, Any]) -> list[dict[str, Any]]:
        try:
            parsed = self._parse_args(args)
            if parsed is None:
                return []
            search_query, limit, date_gte = parsed
            user_id = args["user_id"]

            with Timer(METRICS, "finchat_retrieval_embed_seconds"):
                query_vector = self.encoder.embed_query(search_query)
            with Timer(METRICS, "finchat_retrieval_search_seconds"):
                hits = self.index.query_points(
                    query_vector, limit=limit, user_id=user_id, date_gte=date_gte
                )
            rows = self._secure_rows(hits, user_id)
            METRICS.inc("finchat_retrievals_total")
            logger.info("Successfully processed %d transactions", len(rows))
            return rows
        except Exception as e:
            logger.error("Error retrieving transactions: %s", e, exc_info=True)
            return []

    # --- ingestion side (the reference's upsert path lives out-of-repo;
    # here it is first-class so the product is self-contained) ------------
    def upsert_transactions(
        self,
        user_id: str,
        texts: list[str],
        dates: list[float] | None = None,
        metadatas: list[dict[str, Any]] | None = None,
    ) -> None:
        """``metadatas`` (e.g. ``{"amount": -12.5, "category": "coffee"}``)
        merge into each point's metadata — the structured fields the plot
        tool charts."""
        from finchat_tpu_torch.embed.index import VectorPoint

        if self.batcher is not None:
            # ingest embeds coalesce with in-flight query embeds (the
            # threadsafe path no-ops to a direct call when no loop runs)
            vectors = self.batcher.embed_threadsafe(texts)
        else:
            vectors = self.encoder.embed_batch(texts)
        dates = dates or [self.now()] * len(texts)
        points = [
            VectorPoint(
                id=f"{user_id}-{i}-{int(dates[i])}",
                vector=vectors[i],
                payload={
                    "page_content": texts[i],
                    "metadata": {
                        **(metadatas[i] if metadatas else {}),
                        "user_id": user_id,
                        "date": dates[i],
                    },
                },
            )
            for i in range(len(texts))
        ]
        self.index.upsert(points)

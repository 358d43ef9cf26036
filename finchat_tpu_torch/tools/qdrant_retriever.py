"""External Qdrant retriever backend (own copy of the JAX package's
``tools/qdrant_retriever.py``).

For deployments with an existing, populated Qdrant cluster, the
reference's own vector backend (``tools/qdrant_tool.py:24-37``,
``query_points`` :147-153). It has the interface of ``TransactionRetriever``
(``__call__`` / ``structured`` / ``upsert_transactions``), so the agent,
the plot tool and the ingestion paths cannot tell the backends apart, and
it keeps every security invariant:

- an empty ``user_id`` gives ``[]`` with no backend call;
- the search carries a server-side must-filter on ``metadata.user_id`` and
  a ``metadata.date >= now - N days`` range when ``time_period_days`` is
  set;
- every returned hit is checked again afterwards, mismatches skipped and
  counted;
- any exception gives ``[]`` with an error log.

The query and ingest embeddings still run on the device
(``embed/encoder.py``); only the search is delegated. Filters and points
are plain dicts (the qdrant client parses them into its models), so this
module imports, and is tested against a fake client, without
``qdrant-client`` installed; the client is imported only when none is
injected. ``build_app`` selects it when ``QDRANT_URL`` is set.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)

DEFAULT_LIMIT = 10_000  # qdrant_tool.py:145
DEFAULT_QUERY = "recent transactions"

# reference search tuning (qdrant_tool.py:98-101)
_SEARCH_PARAMS = {"hnsw_ef": 128, "exact": False}


class QdrantRetriever:
    """Callable RAG tool backed by an external Qdrant service.

    ``client`` is injectable (tests fake it); when omitted, a
    ``qdrant_client.QdrantClient(url=..., api_key=...)`` is constructed
    lazily so the dependency stays optional.
    """

    def __init__(
        self,
        encoder,
        *,
        url: str = "",
        api_key: str = "",
        collection: str = "transactions",
        default_limit: int = DEFAULT_LIMIT,
        now: Callable[[], float] = time.time,
        client: Any = None,
    ):
        if client is None:
            try:
                from qdrant_client import QdrantClient
            except ImportError as e:  # pragma: no cover - env without the pkg
                raise RuntimeError(
                    "QDRANT_URL is set but the 'qdrant-client' package is not "
                    "installed; install it or unset QDRANT_URL to use the "
                    "on-device vector index"
                ) from e
            client = QdrantClient(url=url, api_key=api_key or None)
            logger.info("qdrant retriever: connected to %s (collection=%s)",
                        url, collection)
        self.client = client
        self.encoder = encoder
        self.collection = collection
        self.default_limit = default_limit
        self.now = now

    async def __call__(self, args: dict[str, Any]) -> list[str]:
        return [row["page_content"] for row in await self.structured(args)]

    async def structured(self, args: dict[str, Any]) -> list[dict[str, Any]]:
        """Full rows (page_content + metadata) for the plot tool. The
        device embedding forward + the network round-trip both run in a
        worker thread so token streams on the event loop never stall
        behind a retrieval (same policy as tools/retrieval.py)."""
        import asyncio

        return await asyncio.to_thread(self._structured_sync, args)

    def _structured_sync(self, args: dict[str, Any]) -> list[dict[str, Any]]:
        try:
            user_id = args.get("user_id", "")
            logger.info("Starting transaction retrieval for user_id: %s", user_id)
            if not user_id:
                logger.error("Security violation: user_id not provided")
                return []

            search_query = args.get("search_query") or DEFAULT_QUERY
            limit = args.get("num_transactions") or self.default_limit
            must: list[dict[str, Any]] = [
                {"key": "metadata.user_id", "match": {"value": user_id}}
            ]
            days = args.get("time_period_days")
            if days:
                must.append({
                    "key": "metadata.date",
                    "range": {"gte": int(self.now() - days * 86_400.0)},
                })

            query_vector = self.encoder.embed_query(search_query)
            hits = self.client.query_points(
                collection_name=self.collection,
                query=[float(x) for x in query_vector],
                limit=int(limit),
                query_filter={"must": must},
                search_params=dict(_SEARCH_PARAMS),
                with_payload=True,
            ).points

            rows: list[dict[str, Any]] = []
            skipped = 0
            for hit in hits:
                payload = hit.payload
                metadata = (payload or {}).get("metadata", {})
                content = (payload or {}).get("page_content")
                # post-hoc security re-check, parity with qdrant_tool.py:159-170
                # (content is also .get-checked: one malformed point in an
                # externally-populated cluster skips, not empties, the result)
                if payload and content is not None and metadata.get("user_id") == user_id:
                    rows.append({**metadata, "page_content": content})
                else:
                    skipped += 1
                    logger.warning(
                        "Security check: Skipping transaction with mismatched "
                        "user_id. Expected: %s, Got: %s",
                        user_id, metadata.get("user_id"),
                    )
            if skipped:
                logger.warning("Skipped %d transactions due to user_id mismatch", skipped)
                METRICS.inc("finchat_retrieval_security_skips_total", skipped)

            METRICS.inc("finchat_retrievals_total")
            logger.info("Successfully processed %d transactions", len(rows))
            return rows
        except Exception as e:
            logger.error("Error retrieving transactions: %s", e, exc_info=True)
            return []

    # --- ingestion side (mirrors tools/retrieval.py upsert contract) -----
    def upsert_transactions(
        self,
        user_id: str,
        texts: list[str],
        dates: list[float] | None = None,
        metadatas: list[dict[str, Any]] | None = None,
    ) -> None:
        """Embed on-device, upsert into the external collection with the
        same payload shape the retrieval side (and the reference's
        out-of-band ingestion) expects."""
        vectors = self.encoder.embed_batch(texts)
        dates = dates or [self.now()] * len(texts)
        points = [
            {
                "id": _point_id(user_id, i, dates[i]),
                "vector": [float(x) for x in vectors[i]],
                "payload": {
                    "page_content": texts[i],
                    "metadata": {
                        **(metadatas[i] if metadatas else {}),
                        "user_id": user_id,
                        "date": dates[i],
                    },
                },
            }
            for i in range(len(texts))
        ]
        self.client.upsert(collection_name=self.collection, points=points)


def _point_id(user_id: str, i: int, date: float) -> str:
    """Qdrant point ids must be unsigned ints or UUIDs (unlike the
    in-tree index's free-form strings): derive a stable UUID from the
    same ``user_id/ordinal/date`` identity the device index keys on, so
    re-ingesting the same row overwrites instead of duplicating."""
    import uuid

    return str(uuid.uuid5(uuid.NAMESPACE_URL, f"{user_id}-{i}-{int(date)}"))

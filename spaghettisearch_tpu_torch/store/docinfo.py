"""Per-document metadata record.

Field-for-field equivalent of the reference's DocInfo
(reference: database/noschema_schema.go:34-44): URL, raw title words,
modification date, page size, child doc hashes, parent->anchor-texts map,
and wordHash->frequency map. Serialized as JSON with ISO-8601 dates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

#: "zero" mod-date marking a stub DocInfo created for a not-yet-crawled child
#: (reference: indexer/indexer.go:179 uses Go's zero time.Time)
ZERO_TIME = datetime(1, 1, 1, tzinfo=timezone.utc)


@dataclass
class DocInfo:
    url: str
    page_title: list[str] = field(default_factory=list)
    mod_date: datetime = ZERO_TIME
    page_size: int = 0
    children: list[str] = field(default_factory=list)
    #: parent docHash -> anchor-text tokens pointing at this doc
    parents: dict[str, list[str]] = field(default_factory=dict)
    #: body wordHash -> frequency
    words_mapping: dict[str, int] = field(default_factory=dict)

    @property
    def is_stub(self) -> bool:
        """True for placeholder records of never-crawled children."""
        return self.mod_date == ZERO_TIME

    @property
    def host(self) -> str:
        from urllib.parse import urlsplit

        return urlsplit(self.url).hostname or ""

    def to_json(self) -> dict[str, Any]:
        return {
            "Url": self.url,
            "Page_title": self.page_title,
            "Mod_date": self.mod_date.isoformat(),
            "Page_size": self.page_size,
            "Children": self.children,
            "Parents": self.parents,
            "Words_mapping": self.words_mapping,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "DocInfo":
        return cls(
            url=d["Url"],
            page_title=list(d.get("Page_title") or []),
            mod_date=datetime.fromisoformat(d["Mod_date"]),
            page_size=int(d.get("Page_size") or 0),
            children=list(d.get("Children") or []),
            parents={k: list(v or []) for k, v in (d.get("Parents") or {}).items()},
            words_mapping={k: int(v) for k, v in (d.get("Words_mapping") or {}).items()},
        )

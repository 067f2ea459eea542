"""Dump all nine tables (reference: cmd/debug_db.go:10-28)."""

from __future__ import annotations

import argparse
import json

from ..store.tables import TABLE_SPECS, Database


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Dump store tables")
    ap.add_argument("--db", default="./db_data")
    ap.add_argument("--table", choices=[s.name for s in TABLE_SPECS], default=None)
    ap.add_argument("--limit", type=int, default=0, help="rows per table (0 = all)")
    args = ap.parse_args(argv)

    db = Database(args.db)
    specs = [s for s in TABLE_SPECS if args.table in (None, s.name)]
    for spec in specs:
        table = db.tables[spec.name]
        print(f"===== {spec.name} ({spec.reference_name}): {len(table)} rows =====")
        for i, (k, v) in enumerate(table.items()):
            if args.limit and i >= args.limit:
                print("  ...")
                break
            enc = spec.encode(v)
            print(f"  {k} -> {json.dumps(enc)[:300]}")


if __name__ == "__main__":
    main()

"""Doc-sharded scale-out: device meshes, the sharded index, its scorers and
PageRank."""

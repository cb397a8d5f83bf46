from gtos_tpu_torch.graph.ir import Graph
from gtos_tpu_torch.graph.amr import AMRParseError, parse_amr
from gtos_tpu_torch.graph.dependency import dependency_graph
from gtos_tpu_torch.graph.paths import (
    GLOBAL_LABEL, NONE_LABEL, SELF_LABEL, PackedPaths, PathInterner,
    RelationPathConfig, collect_relation_labels, pack_relation_paths,
    relation_paths,
)

__all__ = [
    "Graph", "parse_amr", "AMRParseError", "dependency_graph",
    "GLOBAL_LABEL", "NONE_LABEL", "SELF_LABEL", "PackedPaths",
    "PathInterner", "RelationPathConfig", "collect_relation_labels",
    "pack_relation_paths", "relation_paths",
]

from .cluster_tree import ClusterTree, ClusterTreeBuilder, build_cluster_tree

__all__ = ["ClusterTree", "ClusterTreeBuilder", "build_cluster_tree"]

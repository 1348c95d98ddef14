"""Artifact writers (image grids, the Pareto scatter), the image data
source, and the reference's small CLI helpers."""

from clip_glass_torch.utils.misc import AttributeDict, bool_type, range_type, to_list

__all__ = ["AttributeDict", "bool_type", "range_type", "to_list"]

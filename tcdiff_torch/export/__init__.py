"""Export of the FK pkls: split into one pkl a dancer, BVH (no
dependency), FBX (with the Autodesk FBX SDK) and a headless Blender
launcher."""

from tcdiff_torch.export.blender_launch import blender_available  # noqa: F401
from tcdiff_torch.export.bvh import pkl_to_bvh, write_bvh  # noqa: F401
from tcdiff_torch.export.fbx_export import SmplObjects, fbx_available, pkl_to_fbx  # noqa: F401
from tcdiff_torch.export.split_pkl import split_pkl_file  # noqa: F401

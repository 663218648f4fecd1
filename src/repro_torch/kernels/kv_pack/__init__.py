from .ops import kv_pack, kv_unpack
from .ref import kv_pack_ref, kv_unpack_ref

__all__ = ["kv_pack", "kv_unpack", "kv_pack_ref", "kv_unpack_ref"]

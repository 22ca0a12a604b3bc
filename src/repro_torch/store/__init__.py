"""Tiered durable object store + remotes, on the port.

Turns the device-resident ``ObjectStore`` into a three-tier store:

1. **heap** — device memory, an LRU cache of sealed objects (tier 1);
2. **packs** — a local durable pack directory of content-addressed,
   CRC32C-framed per-lane columnar spill files (tier 2, ``packs.PackDir``),
   in the reference's DGPK v1 bytes;
3. **remote** — a remote directory holding packs + a refs snapshot + the
   WAL, exchanged by ``push``/``pull``/``fetch``/``clone`` (tier 3,
   ``remote``).

Content addresses key by **digest**, never oid: rollback paths rewind the
oid counter (see ``core.objects.ObjectStore``), so a recycled oid must map
to a fresh digest, never to stale bytes.
"""
from .packs import (PACK_MAGIC, PACK_VERSION, PackDir, PackFormatError,
                    attach_packs, blob_digest, decode_object, encode_object)
from .remote import (REFS_MAGIC, REFS_VERSION, RemoteError, clone,
                     decode_refs, encode_refs, export_refs, fetch,
                     import_refs, pull, push, read_remote)

__all__ = [
    "PACK_MAGIC", "PACK_VERSION", "PackDir", "PackFormatError",
    "attach_packs", "blob_digest", "decode_object", "encode_object",
    "REFS_MAGIC", "REFS_VERSION", "RemoteError", "clone", "decode_refs",
    "encode_refs", "export_refs", "fetch", "import_refs", "pull", "push",
    "read_remote",
]

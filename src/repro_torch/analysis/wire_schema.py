"""Wire-schema conformance: a declarative restatement of container v1–v5
cross-checked against the live pack/parse constants.

The container's byte layout is implemented twice on purpose:

* ``codec/format.py`` / ``core/container.py`` hold the *executable*
  layout — the ``struct.Struct`` objects the codec packs and parses
  with;
* this module holds a *declarative* restatement — magics, record format
  strings, record sizes, and the per-version stream sets, written out
  literally from the format documentation.

:func:`check_conformance` diffs the two. A format edit that bumps a
record without updating the docs-level schema (or vice versa — edits the
schema and forgets a version) fails statically, before any blob is ever
round-tripped. The schema also owns :class:`RegionKind`, the enum of
fault-addressable region label templates shared with
:mod:`repro_torch.testing.faults`, so the fault harness and the schema cannot
drift on unit names. The tables are the JAX package's, value for value: a
blob of either package is a blob of the other.
"""

from __future__ import annotations

# repro: allow-file[wire-centralization] — this module IS the declarative
# restatement of the wire layout; duplicating the magics and record
# formats here (to diff against the live ones) is its entire purpose.

import enum
import struct

from repro_torch.analysis.findings import Finding

RULE = "wire-schema"


class RegionKind(enum.Enum):
    """Fault-addressable region label templates (format-string values).

    One member per region species the v4 digests (and the fault harness)
    address. ``label(...)`` renders the concrete label; the members are
    the single source of truth for the strings the harness, the
    integrity sweep tests, and the schema all match on.
    """

    HEADER = "header"
    STREAM = "stream:{name}"
    META_FAMILY = "meta:family"
    LATENT_HEAD = "latent:head"
    LATENT_SHARD = "latent:shard{unit}"
    GUARANTEE_DIR = "guarantee:dir"
    GUARANTEE_SPECIES_PART = "guarantee:s{unit}:{part}"
    BLOB = "blob"

    def label(self, **kw) -> str:
        return self.value.format(**kw)


#: CRC-chain order of one species' guarantee extent (the v4 contract);
#: faults.py iterates parts in exactly this order.
GUARANTEE_PARTS = ("coeff", "index", "basis")


# --------------------------------------------------------------------------
# Declarative layout. Each record: (name, struct format, size in bytes).
# These are deliberately literal — restating them from the format docs is
# the point; do not "fix" a mismatch by importing from format.py.

OUTER_MAGIC = b"GBTC"
LAT3_MAGIC = b"LAT3"
ITG_MAGIC = b"ITG1"

OUTER_RECORDS = (
    ("outer_head", "<4sHH", 8),     # magic, version, n_streams
    ("outer_len", "<Q", 8),         # per-entry stream payload length
)

STREAM_RECORDS = (
    ("meta5_family", "<B", 1),      # v5: encoder-family tag prefixing meta
    ("meta_head", "<BBHHHHH", 12),  # flags, dtype, latent, bt, ph, pw, n_arch
    ("meta_shape", "<IIIId", 24),   # S, T, H, W, latent_bin
    ("gdir_head", "<I", 4),         # species count
    ("gdir_rec", "<ddIIQQQ", 48),   # tau, eb, rank, nb, coeff/index/basis len
    ("lat3_head", "<4sIIQI", 24),   # magic, n_shards, shard_rows, rows, cols
    ("lat3_cb", "<I", 4),           # codebook symbol count
    ("lat3_len", "<Q", 8),          # per-shard payload byte length
    ("itg_head", "<4sH", 6),        # magic, n_streams
    ("itg_crc", "<I", 4),           # one CRC32 digest
    ("itg_units", "<III", 12),      # region_len, region_crc, n_units
)

#: version -> (base streams, adds guarantee dir?, per-species streams?,
#: integrity?). Expressed as an explicit table, one row per version.
VERSIONS = (1, 2, 3, 4, 5)

#: declarative restatement of the registered encoder families and their
#: v5 meta-stream wire tags (compare ``repro_torch.codec.families.registered``);
#: written out literally from the format docs, on purpose — an
#: unregistered tag or a registry/schema drift must fail statically.
FAMILY_TAGS = (
    ("conv", 1),
    ("attention", 2),
)


def expected_stream_set(version: int, n_species: int,
                        has_correction: bool) -> frozenset:
    """Schema-side restatement of the per-version stream sets (compare
    :func:`repro_torch.codec.format.expected_stream_set`)."""
    if version not in VERSIONS:
        raise ValueError(f"unknown container version {version}")
    names = {"meta", "latent", "decoder"}
    if has_correction:
        names.add("correction")
    if version == 1:
        names.update(f"guarantee{s}" for s in range(n_species))
    else:
        names.add("guarantee")
    if version >= 4:
        names.add("integrity")
    return frozenset(names)


# --------------------------------------------------------------------------
# Conformance


def _live_records():
    """(name, live Struct) pairs mirroring the declarative tables."""
    from repro_torch.codec import format as wire
    from repro_torch.core import container as container_format

    return {
        "outer_head": container_format._HEAD,
        "outer_len": container_format._LEN,
        "meta5_family": wire._META_FAMILY,
        "meta_head": wire._META_HEAD,
        "meta_shape": wire._META_SHAPE,
        "gdir_head": wire._GDIR_HEAD,
        "gdir_rec": wire._GDIR_REC,
        "lat3_head": wire._LAT3_HEAD,
        "lat3_cb": wire._LAT3_CB,
        "lat3_len": wire._LAT3_LEN,
        "itg_head": wire._ITG_HEAD,
        "itg_crc": wire._ITG_CRC,
        "itg_units": wire._ITG_UNITS,
    }


def check_conformance() -> list:
    """Cross-check the declarative schema against the implementation.

    Covers all five container versions: outer framing, every stream
    record layout, the magics, the supported-version tuple, and the
    per-version stream sets (schema table vs
    ``format.expected_stream_set`` over representative shapes). Returns
    findings; empty means conformant.
    """
    from repro_torch.codec import format as wire
    from repro_torch.core import container as container_format

    here = "analysis/wire_schema.py"
    out = []

    def finding(detail):
        out.append(Finding(RULE, here, 0, detail))

    # magics
    if container_format.MAGIC != OUTER_MAGIC:
        finding(f"outer magic: schema {OUTER_MAGIC!r} != "
                f"live {container_format.MAGIC!r}")
    if wire._LAT3_MAGIC != LAT3_MAGIC:
        finding(f"latent v3 magic: schema {LAT3_MAGIC!r} != "
                f"live {wire._LAT3_MAGIC!r}")
    if wire._ITG_MAGIC != ITG_MAGIC:
        finding(f"integrity magic: schema {ITG_MAGIC!r} != "
                f"live {wire._ITG_MAGIC!r}")

    # version table
    if tuple(container_format.SUPPORTED_VERSIONS) != VERSIONS:
        finding(f"supported versions: schema {VERSIONS} != "
                f"live {tuple(container_format.SUPPORTED_VERSIONS)}")

    # record layouts: declared format string and size must both match the
    # live Struct (size is re-derived independently as a typo check)
    live = _live_records()
    for name, fmt, size in OUTER_RECORDS + STREAM_RECORDS:
        if struct.calcsize(fmt) != size:
            finding(f"record {name}: declared size {size} does not match "
                    f"its own format {fmt!r} ({struct.calcsize(fmt)})")
        st = live.get(name)
        if st is None:
            finding(f"record {name}: no live Struct mapped")
            continue
        if st.format != fmt:
            finding(f"record {name}: schema format {fmt!r} != "
                    f"live {st.format!r}")
        if st.size != size:
            finding(f"record {name}: schema size {size} != live {st.size}")

    # per-version stream sets, exercised over representative shapes for
    # every supported version
    for version in VERSIONS:
        for n_species, has_corr in ((1, False), (3, True), (4, False),
                                    (58, True)):
            want = expected_stream_set(version, n_species, has_corr)
            got = wire.expected_stream_set(version, n_species, has_corr)
            if got != want:
                finding(
                    f"stream set v{version} (S={n_species}, "
                    f"corr={has_corr}): schema {sorted(want)} != "
                    f"live {sorted(got)}"
                )

    # region-label vocabulary: the fault harness must build labels from
    # RegionKind templates (checked by construction — faults.py imports
    # them — but the part order is wire-visible via the CRC chain)
    if GUARANTEE_PARTS != ("coeff", "index", "basis"):
        finding("guarantee part order drifted from the v4 CRC chain")

    # encoder-family tags: the schema's literal table vs the live
    # registry — a family registered without a schema row (or a tag
    # renumbering) is wire drift, caught before any v5 blob exists
    from repro_torch.codec import families

    live_families = families.registered()
    if FAMILY_TAGS != live_families:
        finding(f"family tags: schema {FAMILY_TAGS} != "
                f"registry {live_families}")
    for name, tag in FAMILY_TAGS:
        fam = families.by_tag(tag)
        if fam is None or fam.name != name:
            finding(f"family tag {tag} ({name!r}) does not resolve through "
                    f"families.by_tag")
    if families.by_tag(0) is not None:
        finding("family tag 0 is reserved as invalid but resolves")

    return out

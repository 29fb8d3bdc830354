"""AVIF still images: the HEIF boxes, read as libavif 1.3 reads them for
Pillow's AVIF plugin.

:func:`parse` walks the file's boxes (``ftyp``, ``meta`` with ``hdlr``,
``pitm``, ``iinf``/``infe``, ``iloc``, ``idat``, ``iprp``/``ipco``/``ipma``
and ``iref``) to the primary item's AV1 data and what Pillow's
``convert("RGB")`` and ``ImageOps.exif_transpose`` take from the file: the
colour item's ``ispe``, ``av1C``, ``colr`` (``nclx``, and an ICC profile,
kept and not applied, as Pillow keeps it), ``pixi``, ``irot``, ``imir`` and
``clap`` (recorded, not applied: Pillow leaves it), the alpha auxiliary item
(located, not decoded: ``convert("RGB")`` drops it) and the Exif and XMP
items that describe it. :func:`decode` decodes the AV1 data
(``csrc/host/av1.cc``: an 8-bit lossless key frame, base_q_idx 0, without
screen-content tools, 4:2:0, 4:2:2, 4:4:4 or 4:0:0, in one tile or several)
and converts it to RGB as Pillow's libavif converts it (libyuv's fixed
point with bilinear chroma for BT.601, BT.709 and BT.2020 at either range;
the identity matrix over 4:4:4; gray); :func:`open_avif` is the AVIF row
of ``core/codec.py``'s plugin order.

Three kinds of failure, as Pillow meets them:

- :class:`NotAvif`: what libavif reports as a malformed or truncated file
  type or box, which Pillow's plugin raises as ``SyntaxError``, so that
  ``Image.open`` goes on to the next plugin;
- :class:`AvifError`: any other failure of libavif or dav1d, which Pillow
  raises from ``Image.open`` or its ``load``;
- :class:`AvifRefused` (and the AV1 decoder's refusals): a file Pillow
  decodes and the port does not, named: lossy frames, screen-content
  tools, 10- and 12-bit streams, superres, film grain, several operating
  points or layers (``a1op``, ``lsel``), image sequences (``avis``),
  ``grid`` images, premultiplied alpha (``prem``), a frame of another size
  than its ``ispe`` (libavif scales it) and the matrices libavif converts
  in float (BT.470M, SMPTE 240M, YCgCo, chroma-derived, YCgCo-Re).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class NotAvif(Exception):
    """libavif's INVALID_FTYP, BMFF_PARSE_FAILED or TRUNCATED_DATA at parse
    time: Pillow's ``SyntaxError``, on which ``Image.open`` tries the next
    plugin."""


class AvifError(ValueError):
    """A failure Pillow raises (libavif past its parse, or dav1d)."""


class AvifRefused(ValueError):
    """A file Pillow decodes and the port does not; ``what`` names it."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what


# the properties libavif reads; an essential one of another type makes its
# item unsupported
KNOWN = (b"av1C", b"ispe", b"colr", b"pixi", b"irot", b"imir", b"clap", b"auxC", b"pasp",
         b"clli", b"a1op", b"lsel", b"a1lx")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


@dataclass
class Item:
    id: int
    type: bytes = b""
    content_type: bytes = b""
    extents: List[Tuple[int, int]] = field(default_factory=list)  # (offset, length)
    method: int = 0
    props: List[Tuple[int, bool]] = field(default_factory=list)  # (property index, essential)
    has_loc: bool = False


@dataclass
class Avif:
    """What the decode needs from the file."""

    obus: bytes
    width: int
    height: int
    nclx: Optional[Tuple[int, int, int, int]]  # primaries, transfer, matrix, full range
    icc: Optional[bytes]
    irot: int  # counter-clockwise quarter turns
    imir: Optional[int]  # mirror axis
    clap: Optional[Tuple[int, ...]]
    alpha: Optional[bytes]  # the alpha item's AV1 data
    exif: Optional[bytes]
    xmp: Optional[bytes]

    def exif_orientation(self) -> int:
        """The EXIF orientation Pillow's ``_avif`` derives from ``irot`` and
        ``imir`` (its ``irot_imir_to_exif_orientation``)."""
        axis = self.imir
        if self.irot == 1:
            return 8 if axis is None else (7 if axis else 5)
        if self.irot == 2:
            return 3 if axis is None else (4 if axis else 2)
        if self.irot == 3:
            return 6 if axis is None else (5 if axis else 7)
        if axis is not None:
            return 2 if axis else 4
        return 1


class _Stream:
    """A bounded reader over data[pos:end], failing as libavif's avifROStream."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def left(self) -> int:
        return self.end - self.pos

    def read(self, n: int) -> bytes:
        if n < 0 or n > self.left():
            raise NotAvif("a box runs past its parent")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.read(n), "big") if n else 0

    def version(self, allowed=None) -> Tuple[int, int]:
        v, flags = self.u(1), self.u(3)
        if allowed is not None and v not in allowed:
            raise NotAvif(f"a box of version {v}")
        return v, flags

    def string(self) -> bytes:
        end = self.data.find(b"\0", self.pos, self.end)
        if end < 0:
            raise NotAvif("a string without its terminator")
        s = self.data[self.pos:end]
        self.pos = end + 1
        return s

    def box(self, top: bool = False):
        """(type, body start, body end) of the next box; a size-0 box runs
        to the end only at the file level."""
        start = self.pos
        size, typ = self.u(4), self.read(4)
        if size == 1:
            size = self.u(8)
        if typ == b"uuid":
            self.read(16)
        head = self.pos - start
        if size == 0 and top:
            return typ, self.pos, self.end, True
        if size < head:
            raise NotAvif("a box smaller than its header")
        if size - head > self.left():
            if top:
                return typ, self.pos, start + size, False
            raise NotAvif("a child box too large")
        return typ, self.pos, start + size, False


def _ftyp(s: _Stream) -> Tuple[bytes, List[bytes]]:
    major = s.read(4)
    s.u(4)
    if s.left() % 4:
        raise NotAvif("ftyp's compatible brands are not whole")
    brands = [s.read(4) for _ in range(s.left() // 4)]
    return major, brands


def _hdlr(s: _Stream) -> None:
    s.version((0,))
    if s.u(4) != 0:
        raise NotAvif("hdlr's pre_defined is not zero")
    if s.read(4) != b"pict":
        raise NotAvif("hdlr's handler is not pict")
    for _ in range(3):
        s.u(4)
    s.string()


def _iloc(s: _Stream, items: Dict[int, Item]) -> None:
    version, _ = s.version((0, 1, 2))
    sizes = s.u(1)
    offset_size, length_size = sizes >> 4, sizes & 15
    sizes = s.u(1)
    base_size = sizes >> 4
    index_size = sizes & 15 if version in (1, 2) else 0
    for n in (offset_size, length_size, base_size, index_size):
        if n not in (0, 4, 8):
            raise NotAvif("iloc field sizes other than 0, 4 and 8")
    count = s.u(2 if version < 2 else 4)
    seen = set()
    for _ in range(count):
        item_id = s.u(2 if version < 2 else 4)
        if item_id in seen:
            raise NotAvif("an item located twice")
        seen.add(item_id)
        method = s.u(2) & 15 if version in (1, 2) else 0
        if method not in (0, 1):
            raise NotAvif(f"iloc construction method {method}")
        s.u(2)  # data_reference_index: libavif does not read it
        base = s.u(base_size)
        extents = s.u(2)
        if extents == 0:
            raise NotAvif("an item without extents")
        item = items.setdefault(item_id, Item(item_id))
        item.method, item.has_loc = method, True
        for _ in range(extents):
            if index_size:
                s.u(index_size)
            off, length = s.u(offset_size), s.u(length_size)
            if base + off > 0xFFFFFFFFFFFFFFFF:
                raise NotAvif("an extent offset overflows")
            item.extents.append((base + off, length))


def _iinf(s: _Stream, items: Dict[int, Item]) -> None:
    version, _ = s.version((0, 1))
    count = s.u(2 if version == 0 else 4)
    for _ in range(count):
        typ, start, end, _z = s.box()
        if typ != b"infe":
            raise NotAvif("iinf holds a box that is not infe")
        e = _Stream(s.data, start, end)
        v, _ = e.version()
        if v not in (2, 3):
            raise NotAvif(f"infe version {v}")
        item_id = e.u(2 if v == 2 else 4)
        e.u(2)
        item_type = e.read(4)
        e.string()
        item = items.setdefault(item_id, Item(item_id))
        if item.type:
            raise NotAvif("an item described twice")
        item.type = item_type
        if item_type == b"mime":
            item.content_type = e.string()
        s.pos = end


def _ipma(s: _Stream, items: Dict[int, Item], nprops: int) -> None:
    version, flags = s.version((0, 1))
    count = s.u(4)
    seen = set()
    for _ in range(count):
        item_id = s.u(2 if version < 1 else 4)
        if item_id in seen:
            raise NotAvif("an item associated twice")
        seen.add(item_id)
        item = items.setdefault(item_id, Item(item_id))
        for _ in range(s.u(1)):
            if flags & 1:
                v = s.u(2)
                essential, index = bool(v >> 15), v & 0x7FFF
            else:
                v = s.u(1)
                essential, index = bool(v >> 7), v & 0x7F
            if index == 0:
                continue
            if index > nprops:
                raise NotAvif("ipma names a property ipco lacks")
            item.props.append((index - 1, essential))


def _iref(s: _Stream, refs: List[Tuple[bytes, int, int]]) -> None:
    version, _ = s.version()
    while s.left() and version in (0, 1):  # libavif skips other versions
        typ, start, end, _z = s.box()
        r = _Stream(s.data, start, end)
        src = r.u(2 if version == 0 else 4)
        for _ in range(r.u(2)):
            refs.append((typ, src, r.u(2 if version == 0 else 4)))
        s.pos = end


def _property(typ: bytes, s: _Stream):
    """A property libavif reads, as a tuple; None for the ones it keeps
    opaque."""
    if typ == b"ispe":
        s.version((0,))
        return (s.u(4), s.u(4))
    if typ == b"av1C":
        body = s.read(s.left())
        if len(body) < 4 or body[0] != 0x81:
            raise NotAvif("av1C's marker or version")
        return body
    if typ == b"colr":
        kind = s.read(4)
        if kind == b"nclx":
            p, t, m, r = s.u(2), s.u(2), s.u(2), s.u(1)
            if r & 0x7F:
                raise NotAvif("nclx's reserved bits are set")
            return ("nclx", p, t, m, r >> 7)
        if kind in (b"prof", b"rICC"):
            return ("icc", s.read(s.left()))
        return ("other",)
    if typ == b"pixi":
        s.version((0,))
        n = s.u(1)
        return tuple(s.u(1) for _ in range(n))
    if typ == b"auxC":
        s.version((0,))
        return s.string()
    if typ == b"irot":
        return s.u(1) & 3
    if typ == b"imir":
        return s.u(1) & 1
    if typ == b"clap":
        return tuple(s.u(4) for _ in range(8))
    return None


def _read_item(data: bytes, item: Item, idat: Optional[bytes]) -> bytes:
    out = bytearray()
    for off, length in item.extents:
        src = idat if item.method == 1 else data
        if src is None:
            raise AvifError("an item in idat without idat")
        if length == 0:
            length = len(src) - off
        if off > len(src) or length > len(src) - off:
            raise AvifError("an item runs past the file (truncated)")
        out += src[off:off + length]
    return bytes(out)


def _check_config(av1c, pixi) -> None:
    """An item's av1C and pixi as libavif's avifDecoderItemValidateProperties
    holds them: av1C present; pixi's channels of one depth (libavif: not
    implemented), that of av1C."""
    if not av1c:
        raise NotAvif("an image item without av1C")
    if pixi:
        depths = pixi[0][0]
        if not depths or len(set(depths)) > 1:
            raise AvifError("pixi's channels differ in depth (libavif: not implemented)")
        high, twelve = av1c[0][0][2] >> 6 & 1, av1c[0][0][2] >> 5 & 1
        if depths[0] != (12 if twelve else 10 if high else 8):
            raise NotAvif("pixi's depth is not av1C's")


def parse(data: bytes) -> Avif:
    """The file's primary image as libavif's avifDecoderParse and Pillow's
    ``get_info`` find it."""
    top = _Stream(data, 0, len(data))
    ftyp = meta = None
    while top.left():
        if top.left() < 8:
            raise NotAvif("a box header runs past the file")
        typ, start, end, zero = top.box(top=True)
        if typ in (b"ftyp", b"meta", b"moov") and end > len(data):
            raise NotAvif("a box runs past the file (truncated)")
        if typ == b"ftyp":
            if ftyp is not None:
                raise NotAvif("two ftyp boxes")
            ftyp = _ftyp(_Stream(data, start, end))
            brands = [ftyp[0]] + ftyp[1]
            if b"avif" not in brands and b"avis" not in brands:
                raise NotAvif("ftyp names neither avif nor avis")
        elif typ == b"meta":
            if meta is not None:
                raise NotAvif("two meta boxes")
            meta = (start, end)
        if ftyp is not None and meta is not None:
            break
        if zero:
            break
        top.pos = end
    if ftyp is None:
        raise NotAvif("no ftyp")
    brands = [ftyp[0]] + ftyp[1]
    if meta is None:
        if b"avis" in brands:
            raise AvifRefused("image sequences (avis)")
        raise NotAvif("no meta (truncated)")
    if ftyp[0] == b"avis":
        raise AvifRefused("image sequences (avis)")

    items: Dict[int, Item] = {}
    props: List[Tuple[bytes, object]] = []
    refs: List[Tuple[bytes, int, int]] = []
    primary = None
    idat = None
    s = _Stream(data, *meta)
    s.version((0,))
    first, seen = True, set()
    while s.left():
        typ, start, end, _z = s.box()
        b = _Stream(data, start, end)
        if first:
            if typ != b"hdlr":
                raise NotAvif("meta's first box is not hdlr")
            _hdlr(b)
            first = False
        elif typ in (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            if typ in seen:
                raise NotAvif(f"two {typ.decode()} boxes")
            seen.add(typ)
            if typ == b"iloc":
                _iloc(b, items)
            elif typ == b"pitm":
                v, _ = b.version((0, 1))
                primary = b.u(2 if v == 0 else 4)
            elif typ == b"idat":
                idat = data[start:end]
            elif typ == b"iinf":
                _iinf(b, items)
            elif typ == b"iref":
                _iref(b, refs)
            else:  # iprp: ipco, then ipma boxes
                ipco = False
                while b.left():
                    t2, s2, e2, _z2 = b.box()
                    if t2 == b"ipco":
                        if ipco:
                            raise NotAvif("two ipco boxes")
                        ipco = True
                        c = _Stream(data, s2, e2)
                        while c.left():
                            t3, s3, e3, _z3 = c.box()
                            props.append((t3, _property(t3, _Stream(data, s3, e3))))
                            c.pos = e3
                    elif t2 == b"ipma":
                        _ipma(_Stream(data, s2, e2), items, len(props))
                    b.pos = e2
        s.pos = end
    if first:
        raise NotAvif("meta without hdlr")

    def found(item: Item, typ: bytes):
        return [(props[i][1], ess) for i, ess in item.props if props[i][0] == typ]

    def usable(item: Item) -> bool:
        """An item libavif reads: with data, and no essential property it
        does not know (such an item is passed over)."""
        return sum(n for _, n in item.extents) > 0 and not any(
            ess and props[i][0] not in KNOWN for i, ess in item.props)

    for item in items.values():
        if any(ess and props[i][0] == b"a1lx" for i, ess in item.props):
            raise NotAvif("a1lx marked essential")
    # every image item with data needs a valid ispe (avifDecoderReset)
    for item in items.values():
        if item.type in (b"av01", b"grid") and usable(item):
            size = found(item, b"ispe")
            if not size:
                raise NotAvif(f"item {item.id} has no ispe")
            w, h = size[0][0]
            if not w or not h or w > 32768 or h > 32768 or w * h > 16384 * 16384:
                raise NotAvif(f"item {item.id} has a size of {w}x{h}")
    if primary is None or primary not in items or not items[primary].type:
        raise AvifError("no primary item")
    color = items[primary]
    if color.type == b"grid":
        raise AvifRefused("grid derived images")
    if color.type != b"av01":
        raise AvifError("the primary item is not an AV1 image")
    if any(ess and props[i][0] not in KNOWN for i, ess in color.props):
        raise AvifError("the colour item has an essential property libavif does not know")
    ispe = found(color, b"ispe")
    if not ispe:
        raise AvifError("the colour item has no ispe")
    _check_config(found(color, b"av1C"), found(color, b"pixi"))
    if found(color, b"a1op") or found(color, b"lsel"):
        raise AvifRefused("several operating points or layers")
    nclx = icc = None
    for value, _ess in found(color, b"colr"):
        if value[0] == "nclx":
            if nclx is not None:
                raise AvifError("two nclx colr boxes")
            nclx = value[1:]
        elif value[0] == "icc":
            if icc is not None:
                raise AvifError("two ICC colr boxes")
            icc = value[1]
    irot = found(color, b"irot")
    imir = found(color, b"imir")
    clap = found(color, b"clap")
    if not color.has_loc:
        raise AvifError("the colour item has no location")
    obus = _read_item(data, color, idat)

    # the alpha auxiliary item and the metadata that describe the colour item
    alpha = None
    prem = False
    exif = xmp = None
    for typ, src, dst in refs:
        if typ == b"prem" and src == primary:
            prem = True
    for item in items.values():
        if item.id == primary:
            continue
        links = {t for t, src, dst in refs if src == item.id and dst == primary}
        if b"auxl" in links and item.type == b"av01" and alpha is None and usable(item):
            aux = found(item, b"auxC")
            if aux and aux[0][0] in ALPHA_URNS:
                _check_config(found(item, b"av1C"), found(item, b"pixi"))
                if not found(item, b"ispe"):
                    raise NotAvif("the alpha item has no ispe")
                if found(item, b"ispe")[0][0] != ispe[0][0]:
                    raise AvifError("the alpha item's ispe is not the colour item's")
                alpha = _read_item(data, item, idat)
        if b"cdsc" in links and item.has_loc:
            if item.type == b"Exif" and exif is None:
                payload = _read_item(data, item, idat)
                if len(payload) < 4:
                    raise AvifError("an Exif item without its header offset")
                exif = payload[4:]
                at = [i for i in (exif.find(b"II*\0"), exif.find(b"MM\0*")) if i >= 0]
                if not at or min(at) != int.from_bytes(payload[:4], "big"):
                    raise AvifError("an Exif item's TIFF header is not at its offset")
            elif (item.type == b"mime" and item.content_type == b"application/rdf+xml"
                  and xmp is None):
                xmp = _read_item(data, item, idat)
    if prem and alpha is not None:
        raise AvifRefused("premultiplied alpha (prem)")
    w, h = ispe[0][0]
    return Avif(obus=obus, width=w, height=h, nclx=nclx, icc=icc,
                irot=irot[0][0] if irot else 0, imir=imir[0][0] if imir else None,
                clap=clap[0][0] if clap else None, alpha=alpha,
                exif=exif, xmp=xmp)


# ---------------------------------------------------------------------------
# The AVIF row of core/codec.py's plugin order
# ---------------------------------------------------------------------------

def open_avif(data: bytes):
    """The AVIF plugin's ``_open``: the boxes as libavif's parse reads them;
    what libavif reports as a bad file type or box passes the file on, as
    Pillow's ``SyntaxError`` does. Returns the loader of the RGB array."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    try:
        image = parse(data)
    except NotAvif as e:
        raise codec._NotThisFormat(f"AVIF: {e}") from None
    except AvifRefused as e:
        raise codec._Refused("AVIF", e.what) from None
    except AvifError as e:
        raise ValueError(f"corrupt AVIF: {e}") from None
    if image.width <= 0 or image.height <= 0:
        raise codec._NotThisFormat("AVIF: no size")
    codec._bomb("AVIF", image.width, image.height)
    return lambda: decode(image)


def _library():
    """The codec library with the AV1 entry points' signatures."""
    import ctypes

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    lib = codec.library()
    if lib.qie_av1_info.argtypes is None:
        vp, ci, cl, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_char_p
        lib.qie_av1_info.argtypes = [cp, cl, vp, vp, ci]
        lib.qie_av1_decode.argtypes = [cp, cl, vp, vp, vp, vp, ci]
        lib.qie_avif_rgb.argtypes = [vp, vp, vp] + [ci] * 7 + [vp, vp, ci]
        for fn in (lib.qie_av1_info, lib.qie_av1_decode, lib.qie_avif_rgb):
            fn.restype = ci
    return lib


def _call(status: int, err) -> None:
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    if status == -2:
        raise codec._Refused("AVIF", err.value.decode())
    if status != 0:
        raise ValueError(err.value.decode())


def decode(image: Avif):
    """The primary item's AV1 frame (``csrc/host/av1.cc``) as (H, W, 3)
    uint8 RGB, converted as Pillow's libavif converts it
    (``qie_avif_rgb``: libyuv's fixed point and bilinear chroma, the matrix
    and range from ``colr``, else from the sequence header), then the
    orientation ``exif_transpose`` applies."""
    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    lib, err = _library(), codec._err()
    y, u, v, info = _planes(lib, image.obus, err)
    h, w = y.shape
    if (w, h) != (image.width, image.height):
        raise codec._Refused("AVIF", "a frame of another size than its ispe (libavif scales it)")
    ssx, ssy, mono = (int(k) for k in info[2:5])
    if image.alpha is not None:  # libavif decodes the alpha item that convert("RGB") drops
        try:
            _planes(lib, image.alpha, err)
        except codec._Refused:
            pass  # a stream of the alpha item's kind the port does not decode: not checked
        except ValueError as e:
            raise ValueError(f"{e} (the alpha item)") from None
    matrix, full = (image.nclx[2], image.nclx[3]) if image.nclx else (int(info[10]), int(info[6]))
    rgb = np.empty((h, w, 3), np.uint8)
    _call(lib.qie_avif_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, ssx, ssy, mono,
                           matrix, full, rgb.ctypes.data, err, len(err)), err)
    return codec._orient(rgb, orientation(image))


def _planes(lib, obus: bytes, err):
    """(y, u, v, info) of an AV1 item's frame, cropped to its size."""
    import numpy as np

    info = np.zeros(12, np.int32)
    _call(lib.qie_av1_info(obus, len(obus), info.ctypes.data, err, len(err)), err)
    w, h, ssx, ssy = (int(k) for k in info[:4])
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    y = np.empty((h, w), np.uint8)
    u = np.empty((ch, cw), np.uint8)
    v = np.empty((ch, cw), np.uint8)
    _call(lib.qie_av1_decode(obus, len(obus), y.ctypes.data, u.ctypes.data, v.ctypes.data,
                             err, len(err)), err)
    return y, u, v, info


def orientation(image: Avif) -> int:
    """What ``exif_transpose`` applies to Pillow's AVIF image: its ``_open``
    writes the orientation of ``irot`` and ``imir`` into the EXIF where that
    differs from the Exif item's (or there is an Exif item), so the EXIF's
    tag, or else the XMP packet's, counts only where they agree."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    own = image.exif_orientation()
    tag = codec._exif_tag(image.exif) if image.exif is not None else None
    if image.exif is None and own == 1:
        return codec.orientation(None, image.xmp)
    if own != (1 if tag is None else tag):
        return own
    return codec.orientation(image.exif, image.xmp) if image.exif is not None else own

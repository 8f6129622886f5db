"""Minimal self-contained searchable-PDF writer and text extractor (stdlib only).

The reference builds the searchable PDF's invisible text layer with
ReportLab (inference_pdf.py:144-196), which is an optional dependency. This
module is a copy of the JAX package's pure-Python writer, over stdlib
zlib/struct:

  * ``TrueTypeFont``: parses a .ttf's ``cmap`` (formats 4/12), ``head``,
    ``hhea``/``hmtx`` tables, enough to map Khmer codepoints to glyph ids and
    advance widths.
  * ``SearchablePdfWriter``: writes a one-image page whose image carries the
    visual layer (eraser rects and stamps composited on the host with PIL)
    and repeats each recognised line as an INVISIBLE text run (text
    rendering mode 3) in an embedded Type0/CIDFontType2 font (Identity-H)
    with a ToUnicode CMap, so the Khmer text is selectable, copyable and
    searchable in any conforming viewer.
  * ``extract_pdf_text``: decodes the text layer back out of a PDF (content
    stream ``Tj``/``TJ`` operators through each font's ToUnicode CMap).

PDF 1.4 semantics throughout (ISO 32000; text rendering mode 3 = neither fill
nor stroke, §9.3.6).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

# ---------------------------------------------------------------------------
# TrueType parsing (cmap + metrics)
# ---------------------------------------------------------------------------


class TrueTypeFont:
    """Parses the tables needed to embed a TTF as a PDF CIDFontType2."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.data = self.path.read_bytes()
        self.tables = self._parse_table_directory()
        self.units_per_em = self._parse_head()
        self.cmap = self._parse_cmap()  # {codepoint: glyph id}
        self.advances = self._parse_hmtx()  # glyph id -> advance (font units)

    def _parse_table_directory(self) -> dict[str, tuple[int, int]]:
        (tag,) = struct.unpack(">I", self.data[:4])
        if tag not in (0x00010000, 0x74727565):  # 'true' for legacy Mac TTFs
            raise ValueError(f"{self.path.name}: not a TrueType font (tag {tag:#x})")
        n = struct.unpack(">H", self.data[4:6])[0]
        tables = {}
        for i in range(n):
            off = 12 + 16 * i
            name, _cks, o, length = struct.unpack(">4sIII", self.data[off : off + 16])
            tables[name.decode("latin1")] = (o, length)
        return tables

    def _parse_head(self) -> int:
        o, _ = self.tables["head"]
        return struct.unpack(">H", self.data[o + 18 : o + 20])[0]

    def _parse_cmap(self) -> dict[int, int]:
        o, _ = self.tables["cmap"]
        n = struct.unpack(">H", self.data[o + 2 : o + 4])[0]
        subtables = {}
        for i in range(n):
            pid, eid, off = struct.unpack(">HHI", self.data[o + 4 + 8 * i : o + 12 + 8 * i])
            subtables[(pid, eid)] = o + off
        # preference: full-unicode format 12, then BMP format 4
        for key in ((3, 10), (0, 4), (0, 6), (3, 1), (0, 3)):
            if key in subtables:
                fmt = struct.unpack(">H", self.data[subtables[key] : subtables[key] + 2])[0]
                if fmt == 12:
                    return self._cmap_format12(subtables[key])
                if fmt == 4:
                    return self._cmap_format4(subtables[key])
        raise ValueError(f"{self.path.name}: no usable unicode cmap subtable")

    def _cmap_format4(self, o: int) -> dict[int, int]:
        seg_x2 = struct.unpack(">H", self.data[o + 6 : o + 8])[0]
        segs = seg_x2 // 2
        ends = struct.unpack(f">{segs}H", self.data[o + 14 : o + 14 + seg_x2])
        p = o + 16 + seg_x2
        starts = struct.unpack(f">{segs}H", self.data[p : p + seg_x2])
        p += seg_x2
        deltas = struct.unpack(f">{segs}h", self.data[p : p + seg_x2])
        p += seg_x2
        range_off_base = p
        range_offs = struct.unpack(f">{segs}H", self.data[p : p + seg_x2])
        out = {}
        for i in range(segs):
            for c in range(starts[i], min(ends[i], 0xFFFE) + 1):
                if range_offs[i] == 0:
                    gid = (c + deltas[i]) & 0xFFFF
                else:
                    gp = range_off_base + 2 * i + range_offs[i] + 2 * (c - starts[i])
                    gid = struct.unpack(">H", self.data[gp : gp + 2])[0]
                    if gid:
                        gid = (gid + deltas[i]) & 0xFFFF
                if gid:
                    out[c] = gid
        return out

    def _cmap_format12(self, o: int) -> dict[int, int]:
        n_groups = struct.unpack(">I", self.data[o + 12 : o + 16])[0]
        out = {}
        for i in range(n_groups):
            s, e, g = struct.unpack(">III", self.data[o + 16 + 12 * i : o + 28 + 12 * i])
            for c in range(s, e + 1):
                out[c] = g + (c - s)
        return out

    def _parse_hmtx(self) -> list[int]:
        ho, _ = self.tables["hhea"]
        num_h = struct.unpack(">H", self.data[ho + 34 : ho + 36])[0]
        mo, _ = self.tables["maxp"]
        n_glyphs = struct.unpack(">H", self.data[mo + 4 : mo + 6])[0]
        o, _ = self.tables["hmtx"]
        adv = []
        last = 0
        for i in range(num_h):
            last = struct.unpack(">H", self.data[o + 4 * i : o + 4 * i + 2])[0]
            adv.append(last)
        adv.extend([last] * (n_glyphs - num_h))
        return adv

    def glyph_ids(self, text: str) -> list[int]:
        """codepoints -> glyph ids (0 = .notdef for unmapped)."""
        return [self.cmap.get(ord(ch), 0) for ch in text]

    def width_1000(self, gid: int) -> int:
        """Advance width in PDF glyph space (1/1000 em)."""
        if gid >= len(self.advances):
            return 500
        return round(self.advances[gid] * 1000 / self.units_per_em)


# ---------------------------------------------------------------------------
# PDF writing
# ---------------------------------------------------------------------------


def _pdf_string(b: bytes) -> bytes:
    return b"<" + b.hex().encode() + b">"


def _to_unicode_cmap(gid_to_unicode: dict[int, str]) -> bytes:
    """A ToUnicode CMap stream body: GID (the Identity-H code) -> UTF-16BE."""
    lines = [
        b"/CIDInit /ProcSet findresource begin",
        b"12 dict begin",
        b"begincmap",
        b"/CIDSystemInfo << /Registry (Adobe) /Ordering (UCS) /Supplement 0 >> def",
        b"/CMapName /Adobe-Identity-UCS def",
        b"/CMapType 2 def",
        b"1 begincodespacerange",
        b"<0000> <FFFF>",
        b"endcodespacerange",
    ]
    items = sorted(gid_to_unicode.items())
    for i in range(0, len(items), 100):  # bfchar blocks are capped at 100 entries
        block = items[i : i + 100]
        lines.append(f"{len(block)} beginbfchar".encode())
        for gid, uni in block:
            u16 = uni.encode("utf-16-be")
            lines.append(b"<%04X> <%s>" % (gid, u16.hex().upper().encode()))
        lines.append(b"endbfchar")
    lines += [b"endcmap", b"CMapName currentdict /CMap defineresource pop", b"end", b"end"]
    return b"\n".join(lines)


class SearchablePdfWriter:
    """One-page PDF: page image + invisible selectable text runs."""

    def __init__(self):
        self.objects: list[bytes | None] = [None]  # object numbers are 1-based

    def _add(self, body: bytes) -> int:
        self.objects.append(body)
        return len(self.objects) - 1

    def _add_stream(self, body: bytes, extra_dict: bytes = b"") -> int:
        comp = zlib.compress(body)
        head = b"<< /Length %d /Filter /FlateDecode %s >>\nstream\n" % (len(comp), extra_dict)
        return self._add(head + comp + b"\nendstream")

    def _add_jpeg(self, jpeg_bytes: bytes, w: int, h: int, gray: bool) -> int:
        head = (
            b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
            b"/ColorSpace /Device%s /BitsPerComponent 8 /Filter /DCTDecode /Length %d >>\nstream\n"
            % (w, h, b"Gray" if gray else b"RGB", len(jpeg_bytes))
        )
        return self._add(head + jpeg_bytes + b"\nendstream")

    def _add_font(self, font: TrueTypeFont, used_gids: dict[int, str]) -> int:
        """Embed the full TTF as Type0/CIDFontType2 Identity-H; returns obj id."""
        file_id = self._add_stream(font.data, extra_dict=b"/Length1 %d" % len(font.data))
        base = "Embedded" + font.path.stem.replace(" ", "")[:20]
        desc_id = self._add(
            (
                "<< /Type /FontDescriptor /FontName /%s /Flags 4 "
                "/FontBBox [-1000 -400 2000 1200] /ItalicAngle 0 /Ascent 1000 "
                "/Descent -300 /CapHeight 700 /StemV 80 /FontFile2 %d 0 R >>"
                % (base, file_id)
            ).encode()
        )
        w_entries = " ".join(f"{gid} [{font.width_1000(gid)}]" for gid in sorted(used_gids))
        cid_id = self._add(
            (
                "<< /Type /Font /Subtype /CIDFontType2 /BaseFont /%s "
                "/CIDSystemInfo << /Registry (Adobe) /Ordering (Identity) /Supplement 0 >> "
                "/FontDescriptor %d 0 R /CIDToGIDMap /Identity /DW 500 /W [%s] >>"
                % (base, desc_id, w_entries)
            ).encode()
        )
        tounicode_id = self._add_stream(_to_unicode_cmap(used_gids))
        return self._add(
            (
                "<< /Type /Font /Subtype /Type0 /BaseFont /%s /Encoding /Identity-H "
                "/DescendantFonts [%d 0 R] /ToUnicode %d 0 R >>" % (base, cid_id, tounicode_id)
            ).encode()
        )

    def write(self, out_path: str | Path, page_image, text_items: list[dict],
              font: TrueTypeFont) -> Path:
        """page_image: PIL image (the composited visual layer).
        text_items: [{"text", "bbox": (x0, y0, x1, y1) in image pixel coords,
        y down}]. Invisible text runs are placed over each bbox."""
        import io

        w, h = page_image.size
        gray = page_image.mode == "L"
        buf = io.BytesIO()
        page_image.convert("L" if gray else "RGB").save(buf, format="JPEG", quality=90)
        img_id = self._add_jpeg(buf.getvalue(), w, h, gray)

        # collect glyphs used across all items (one font for the whole layer)
        used: dict[int, str] = {}
        runs = []
        for item in text_items:
            text = item["text"]
            if not text:
                continue
            x0, y0, x1, y1 = (float(v) for v in item["bbox"])
            if x1 <= x0 or y1 <= y0:
                continue
            gids = font.glyph_ids(text)
            for gid, ch in zip(gids, text):
                used.setdefault(gid, ch)
            runs.append((x0, y0, x1, y1, gids))
        font_id = self._add_font(font, used) if runs else None

        content = [b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h)]
        for x0, y0, x1, y1, gids in runs:
            size = max(y1 - y0, 1.0) * 0.75
            baseline_y = h - y1 + (y1 - y0) * 0.2  # PDF origin bottom-left
            code = b"".join(struct.pack(">H", g) for g in gids)
            content.append(
                b"BT /F1 %.2f Tf 3 Tr %.2f %.2f Td %s Tj ET"
                % (size, x0, baseline_y, _pdf_string(code))
            )
        content_id = self._add_stream(b"\n".join(content))

        res = b"<< /XObject << /Im0 %d 0 R >>" % img_id
        if font_id:
            res += b" /Font << /F1 %d 0 R >>" % font_id
        res += b" >>"
        page_id = self._add(
            b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 %d %d] /Resources %s /Contents %d 0 R >>"
            % (len(self.objects) + 1, w, h, res, content_id)
        )
        pages_id = self._add(b"<< /Type /Pages /Kids [%d 0 R] /Count 1 >>" % page_id)
        catalog_id = self._add(b"<< /Type /Catalog /Pages %d 0 R >>" % pages_id)

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(self.objects[1:], start=1):
            offsets.append(len(out))
            out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
        xref_at = len(out)
        n = len(self.objects)
        out += b"xref\n0 %d\n" % n
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += b"%010d 00000 n \n" % off
        out += b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (
            n, catalog_id, xref_at,
        )
        out_path = Path(out_path)
        out_path.write_bytes(bytes(out))
        return out_path


# ---------------------------------------------------------------------------
# PDF text extraction (proves the invisible layer round-trips)
# ---------------------------------------------------------------------------

import re

_OBJ_RE = re.compile(rb"(\d+) 0 obj(.*?)endobj", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_STREAM_START_RE = re.compile(rb"stream\r?\n")
_LENGTH_RE = re.compile(rb"/Length (\d+)")
_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEXPAIR_RE = re.compile(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>")


def _maybe_inflate(obj_body: bytes, data: bytes) -> bytes:
    return zlib.decompress(data) if b"/FlateDecode" in obj_body else data


def _stream_data(obj_body: bytes) -> bytes | None:
    """An object's stream bytes, ``/Length`` of them after the ``stream``
    keyword's end of line. (Searching for the end-of-line before
    ``endstream`` instead cuts a stream whose last byte is a carriage
    return.) Without ``/Length``: up to that end of line."""
    start = _STREAM_START_RE.search(obj_body)
    if start is None:
        return None
    length = _LENGTH_RE.search(obj_body, 0, start.start())
    if length is not None:
        return obj_body[start.end() : start.end() + int(length.group(1))]
    sm = _STREAM_RE.search(obj_body)
    return sm.group(1) if sm else None


def _parse_tounicode(cmap: bytes) -> dict[int, str]:
    out: dict[int, str] = {}
    for block in _BFCHAR_RE.findall(cmap):
        for src, dst in _HEXPAIR_RE.findall(block):
            out[int(src, 16)] = bytes.fromhex(dst.decode()).decode("utf-16-be")
    for block in _BFRANGE_RE.findall(cmap):
        for m in re.finditer(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", block):
            lo, hi, dst = (int(m.group(i), 16) for i in (1, 2, 3))
            for c in range(lo, hi + 1):
                out[c] = chr(dst + c - lo)
    return out


def extract_pdf_text(pdf_path: str | Path) -> list[str]:
    """Decode Tj/TJ text runs through each font's ToUnicode CMap. Returns the
    text runs in content-stream order (one entry per Tj/TJ)."""
    data = Path(pdf_path).read_bytes()
    objects: dict[int, bytes] = {num and int(num): body for num, body in _OBJ_RE.findall(data)}

    # font name (/F1 etc.) -> ToUnicode map, per the page resources
    fonts: dict[bytes, dict[int, str]] = {}
    tounicode_by_obj: dict[int, dict[int, str]] = {}
    for num, body in objects.items():
        if b"/ToUnicode" not in body or b"/Font" not in body:
            continue
        m = re.search(rb"/ToUnicode (\d+) 0 R", body)
        if not m:
            continue
        tu_obj = objects.get(int(m.group(1)), b"")
        stream = _stream_data(tu_obj)
        if stream is not None:
            tounicode_by_obj[num] = _parse_tounicode(_maybe_inflate(tu_obj, stream))
    for num, body in objects.items():
        for fm in re.finditer(rb"/(F\w*)\s+(\d+) 0 R", body):
            if int(fm.group(2)) in tounicode_by_obj:
                fonts[b"/" + fm.group(1)] = tounicode_by_obj[int(fm.group(2))]

    runs: list[str] = []
    for num, body in objects.items():
        if b"/Font" in body or b"/Image" in body:
            continue
        stream = _stream_data(body)
        if stream is None:
            continue
        try:
            content = _maybe_inflate(body, stream)
        except zlib.error:
            continue
        if b"Tj" not in content and b"TJ" not in content:
            continue
        current: dict[int, str] | None = next(iter(fonts.values()), None)
        for tok in re.finditer(
            rb"(/F\w+)\s+[\d.]+\s+Tf|<([0-9A-Fa-f]+)>\s*Tj|\[(.*?)\]\s*TJ", content, re.S
        ):
            fname, hexstr, tj_array = tok.group(1), tok.group(2), tok.group(3)
            if fname is not None:
                current = fonts.get(fname, current)
                continue
            parts = [hexstr] if hexstr is not None else re.findall(rb"<([0-9A-Fa-f]+)>", tj_array)
            text = ""
            for part in parts:
                raw = bytes.fromhex(part.decode())
                for i in range(0, len(raw) - 1, 2):
                    code = struct.unpack(">H", raw[i : i + 2])[0]
                    text += (current or {}).get(code, "�")
            if text:
                runs.append(text)
    return runs

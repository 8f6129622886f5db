"""Searchable PDF: background image + white eraser rects + high-res text
stamps + an invisible selectable text layer.

Reference: inference_pdf.py:107-232. The page image keeps logos and seals;
each recognised line is covered by a white rect, rendered again as a
3x-resolution PNG stamp (fit-to-box font size), and repeated as an
invisible text run so the Khmer text is copyable and searchable.

Backends, in order: ReportLab where it is installed (the reference's), else
the pure-Python writer of pipeline/minipdf.py (the same invisible layer, an
embedded TrueType font with ToUnicode). An error of the writer propagates:
no image-only PDF stands in for a searchable one. Pillow is imported inside
the functions.

    python -m khmer_ocr_torch.pipeline.pdf --image page.png --model khmer_ocr_torch/assets/flagship \\
        --font khmer_ocr_torch/data/fonts/KantumruyPro-Regular.ttf --engine custom --layout-model det-b0
"""

from __future__ import annotations

import io
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def create_high_res_text_stamp(text: str, target_w: int, target_h: int, font_path: str, scale: int = 3):
    """Render text into a transparent ``scale``x canvas with fit-to-box font
    sizing (reference inference_pdf.py:107-141) -> PIL RGBA image."""
    from PIL import Image, ImageDraw, ImageFont

    canvas_w, canvas_h = max(int(target_w * scale), 1), max(int(target_h * scale), 1)
    img = Image.new("RGBA", (canvas_w, canvas_h), (255, 255, 255, 0))
    draw = ImageDraw.Draw(img)
    font_size = max(int(canvas_h * 0.8), 10)
    try:
        font = ImageFont.truetype(font_path, font_size)
    except OSError:
        font = ImageFont.load_default()
        draw.text((0, 0), text, font=font, fill="black")
        return img
    while font_size > 10:
        font = ImageFont.truetype(font_path, font_size)
        bbox = draw.textbbox((0, 0), text, font=font)
        if bbox[2] - bbox[0] < canvas_w * 0.95 and bbox[3] - bbox[1] < canvas_h * 0.95:
            break
        font_size -= 2
    bbox = draw.textbbox((0, 0), text, font=font)
    x = (canvas_w - (bbox[2] - bbox[0])) // 2
    y = (canvas_h - (bbox[3] - bbox[1])) // 2 - bbox[1]
    draw.text((x, y), text, font=font, fill="black")
    return img


def generate_searchable_pdf(image_path, layout_results, output_path, font_path) -> Path:
    """layout_results: [{"text", "bbox"}]. Writes the hybrid PDF through
    ReportLab if it imports, else through pipeline/minipdf.py."""
    try:
        return _reportlab_pdf(image_path, layout_results, output_path, font_path)
    except ImportError:
        pass
    return _minipdf_pdf(image_path, layout_results, output_path, font_path)


def _composite_visual_layer(image_path, layout_results, font_path):
    """Page image + white eraser rects + high-res text stamps: the visual
    half of the hybrid PDF (reference inference_pdf.py:160-189), PIL on the
    host."""
    from PIL import Image, ImageDraw

    page = Image.open(image_path).convert("RGB")
    draw = ImageDraw.Draw(page)
    for item in layout_results:
        text = item["text"]
        x0, y0, x1, y1 = (int(v) for v in item["bbox"])
        if x1 <= x0 or y1 <= y0 or not text:
            continue
        draw.rectangle([x0 - 2, y0 - 2, x1 + 2, y1 + 2], fill="white")
        stamp = create_high_res_text_stamp(text, x1 - x0, y1 - y0, str(font_path))
        stamp = stamp.resize((x1 - x0, y1 - y0))
        page.paste(stamp, (x0, y0), stamp)
    return page


def _minipdf_pdf(image_path, layout_results, output_path, font_path) -> Path:
    """The pure-Python backend: PIL visual layer + invisible text runs
    (rendering mode 3) in an embedded CIDFontType2 with ToUnicode."""
    from .minipdf import SearchablePdfWriter, TrueTypeFont

    page = _composite_visual_layer(image_path, layout_results, font_path)
    font = TrueTypeFont(font_path)
    return SearchablePdfWriter().write(output_path, page, layout_results, font)


def _reportlab_pdf(image_path, layout_results, output_path, font_path) -> Path:
    from PIL import Image
    from reportlab.lib.colors import Color, white
    from reportlab.lib.utils import ImageReader
    from reportlab.pdfbase import pdfmetrics
    from reportlab.pdfbase.ttfonts import TTFont
    from reportlab.pdfgen import canvas as pdf_canvas

    try:
        pdfmetrics.registerFont(TTFont("KhmerFont", str(font_path)))
        have_font = True
    except Exception:
        logger.warning("Khmer font registration failed; copy/paste text layer may render wrong")
        have_font = False

    img = Image.open(image_path)
    width, height = img.size
    c = pdf_canvas.Canvas(str(output_path), pagesize=(width, height))
    c.drawImage(str(image_path), 0, 0, width=width, height=height)

    for item in layout_results:
        text = item["text"]
        x0, y0, x1, y1 = item["bbox"]
        box_w, box_h = x1 - x0, y1 - y0
        if box_w <= 0 or box_h <= 0 or not text:
            continue
        pdf_y = height - y1  # PDF origin is bottom-left
        pad = 2
        c.setFillColor(white)
        c.setStrokeColor(white)
        c.rect(x0 - pad, pdf_y - pad, box_w + 2 * pad, box_h + 2 * pad, fill=1, stroke=1)
        stamp = create_high_res_text_stamp(text, box_w, box_h, str(font_path))
        buf = io.BytesIO()
        stamp.save(buf, format="PNG")
        buf.seek(0)
        c.drawImage(ImageReader(buf), x0, pdf_y, width=box_w, height=box_h, mask="auto")
        if have_font:
            c.setFillColor(Color(0, 0, 0, alpha=0))  # invisible selectable layer
            c.setFont("KhmerFont", box_h * 0.7)
            c.drawString(x0, pdf_y + box_h * 0.15, text)
    c.save()
    return Path(output_path)


def main(argv=None) -> int:
    """Document image -> searchable PDF (reference inference_pdf.py __main__)."""
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Khmer OCR -> searchable PDF")
    p.add_argument("--image", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--font", required=True, help="Khmer .ttf for the text layer")
    p.add_argument("--vocab", default=None)
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--outdir", default="results")
    p.add_argument("--engine", choices=["surya", "custom"], default="surya")
    p.add_argument("--layout-model", default=None, help="SegFormer dir (engine=custom)")
    p.add_argument("--device", type=str, default=None, help="Device (default: the CUDA card)")
    args = p.parse_args(argv)

    from .document import run_layout_aware_pipeline

    results = run_layout_aware_pipeline(args.image, args.model, args.vocab, args.beam, engine=args.engine,
                                        layout_model_dir=args.layout_model, device=args.device)
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    pdf_path = out / (Path(args.image).stem + "_final.pdf")
    generate_searchable_pdf(args.image, results, pdf_path, args.font)
    print(f"PDF saved: {pdf_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's document pipelines, searchable PDF and ``KhmerOCRInference``
against the JAX package's, on the CPU.

* ``KhmerOCRPipeline``'s wiring with a fake detector and recogniser:
  engine='custom' crops, ``process_pages``' worker thread, flushes and line
  accumulation, a worker's exception raised in the caller; the same answers
  as JAX's pipeline in the same scenarios.
* The real thing at small recognizer widths: the seeded SegFormer (an HF
  checkpoint directory) and random reference-layout recognizer weights
  (tests/torch_oracle.py, D = 32, decoder positions cut to 160, as
  ``.safetensors``) read by both packages through their public API:
  ``process_image`` (greedy), ``process_pages`` (beam 3),
  ``run_layout_aware_pipeline(engine="custom")`` and ``KhmerOCRInference``
  (decode cap 128, ``binarize``) give the JAX package's strings; the PDF
  and pipeline CLIs run with ``--device cpu``.
* ``assign_lines_to_blocks``, ``crop_with_padding``, the text stamp and the
  minipdf PDF equal JAX's byte for byte; the surya engine raises its
  ImportError without the package, and its crop geometry equals JAX's. The
  port's text extractor reads each stream by its ``/Length``: JAX's loses
  a stream whose compressed bytes end in a carriage return.

The port runs in torch-only subprocesses (this file run as a script, and
the CLIs) and the JAX package's pipelines in a JAX-only one beside them;
the fake scenarios and host-only pieces of both run in the pytest process.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
EMB, GLOBAL_LEN, DEC_LEN = 32, 256, 160
N_PAGES = 2

sys.path.insert(0, str(REPO))


def page_images():
    from PIL import Image

    from khmer_ocr_torch.data.pages import compose_pages

    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        lines = [z[f"line_{i}"] for i in range(16 * N_PAGES)]
    return [Image.fromarray(p) for p in compose_pages(lines)[0]]


def real_lines(n: int):
    with np.load(REPO / "khmer_ocr_torch" / "assets" / "real_lines.npz") as z:
        return [z[f"line_{i}"] for i in range(n)]


# ---------------------------------------------------------------------------
# scenarios with a fake detector and recogniser, run by both packages
# ---------------------------------------------------------------------------


def fake_scenarios(eng, tmp: Path) -> dict:
    """``eng``: either package's pipeline/engine module."""
    from PIL import Image

    res = {}
    page_path = tmp / "doc.png"
    Image.fromarray(np.full((300, 400), 255, np.uint8)).save(page_path)

    def bare(**kw):
        pipe = eng.KhmerOCRPipeline.__new__(eng.KhmerOCRPipeline)
        pipe.engine, pipe.text_ids = "custom", set(eng.LayoutConfig().text_classes)
        pipe.recognizer_model_path = pipe.vocab_path = pipe.recognize_fn = None
        pipe.device = "cpu"
        pipe.__dict__.update(kw)
        return pipe

    class FakeDetector:
        def run(self, path):
            return [], [([10, 100, 200, 130], 10), ([10, 20, 200, 50], 8), ([10, 200, 150, 280], 7)]

    captured = {}

    def rec(crops, beam_width, batch_size, model_path=None, vocab_path=None, **kw):
        captured.setdefault("calls", []).append(len(crops))
        captured.setdefault("sizes", []).extend([list(c.size) for c in crops])
        base = sum(captured["calls"][:-1])
        return [f"L{base + i}" for i in range(len(crops))]

    eng.recognize_batch = rec
    out = tmp / "res.txt"
    res["wiring"] = dict(text=bare(detector=FakeDetector()).process_image(str(page_path), output_path=str(out)),
                         file=out.read_text(), sizes=captured["sizes"])

    paths = []
    for i in range(6):
        paths.append(tmp / f"page{i}.png")
        Image.fromarray(np.full((60, 80), 255, np.uint8)).save(paths[-1])
    threads = []

    def detect(path, padding):
        threads.append(threading.current_thread().name)
        return [Image.fromarray(np.full((20, 40), 255, np.uint8))] * (int(Path(path).stem[4:]) + 1)

    captured.clear()
    pipe = bare(_detect_crops=detect)
    texts = pipe.process_pages(paths[:5], output_dir=str(tmp / "out"), pages_per_batch=2, beam_width=3,
                               flush_lines=5)
    res["pipelined"] = dict(texts=texts, calls=captured["calls"], threads=sorted(set(threads)),
                            files=[(tmp / "out" / f"page{i}.txt").read_text() for i in range(5)])
    captured.clear()
    pipe = bare(_detect_crops=lambda path, padding: [Image.fromarray(np.full((20, 40), 255, np.uint8))] * 18)
    res["accumulated"] = dict(texts=pipe.process_pages(paths, pages_per_batch=4), calls=captured["calls"])

    def boom(path, padding):
        raise RuntimeError("detector exploded")

    try:
        bare(_detect_crops=boom).process_pages(paths[:1])
        res["worker_error"] = "returned"
    except RuntimeError as e:
        res["worker_error"] = f"RuntimeError: {e}"
    return res


# ---------------------------------------------------------------------------
# the port, in a torch-only subprocess
# ---------------------------------------------------------------------------


def _save_main(tmp: Path) -> None:
    """Random reference-layout recognizer weights (decoder positions cut to
    DEC_LEN) and the seeded SegFormer as HF checkpoint directories."""
    import torch
    from safetensors.numpy import save_file
    from torch_oracle import KhmerOCR

    from khmer_ocr_torch.convert.from_jax import seeded_segformer_state
    from khmer_ocr_torch.detection.segformer import SegFormerConfig, hf_config

    torch.manual_seed(0)
    model = KhmerOCR(vocab_size=124, emb_dim=EMB, max_global_len=GLOBAL_LEN, backbone="se_vgg")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.05)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    sd = {k: v.detach().contiguous().numpy() for k, v in model.state_dict().items()}
    sd["dec.pos_emb"] = np.ascontiguousarray(sd["dec.pos_emb"][:DEC_LEN])
    save_file(sd, str(tmp / "recognizer.safetensors"))
    (tmp / "layout").mkdir()
    (tmp / "layout" / "config.json").write_text(json.dumps(hf_config(SegFormerConfig())))
    save_file({k: v for k, v in seeded_segformer_state(None, 0).items() if v.ndim},
              str(tmp / "layout" / "model.safetensors"))
    for i, img in enumerate(page_images()):
        img.save(tmp / f"doc{i}.png")


def _port_main(tmp: Path) -> None:
    import torch

    from khmer_ocr_torch import KhmerOCRInference, KhmerOCRPipeline
    from khmer_ocr_torch.infer.predictor import Predictor
    from khmer_ocr_torch.pipeline import engine
    from khmer_ocr_torch.pipeline.document import run_layout_aware_pipeline

    torch.set_num_threads(4)
    (tmp / "fake").mkdir()
    res = {"fake": fake_scenarios(engine, tmp / "fake")}
    from khmer_ocr_torch.infer.api import recognize_batch

    engine.recognize_batch = recognize_batch
    rec = str(tmp / "recognizer.safetensors")
    pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=str(tmp / "layout"), recognizer_model_path=rec,
                            device="cpu")
    res["process_image"] = pipe.process_image(str(tmp / "doc0.png"))
    res["process_pages"] = pipe.process_pages([tmp / f"doc{i}.png" for i in range(N_PAGES)], beam_width=3)
    res["layout_aware"] = run_layout_aware_pipeline(str(tmp / "doc0.png"), model_path=rec, engine="custom",
                                                    layout_model_dir=str(tmp / "layout"), device="cpu")
    lines = real_lines(3)
    for binarize in (False, True):
        inf = KhmerOCRInference(rec, binarize=binarize, device="cpu")
        seen = []
        tokens = inf._predictor.predict_batch_tokens

        def spy(images, beam_width=1, batch_size=8, max_len=None, _tokens=tokens):
            seen.append(max_len)
            return _tokens(images, beam_width, batch_size, max_len)

        inf._predictor.predict_batch_tokens = spy
        res[f"standalone/{binarize}"] = dict(
            predict=[inf.predict(line) for line in lines], batch=inf.predict_batch(lines, beam_width=3),
            caps=seen, binarize=inf._predictor.config.preprocess.binarize,
            device=str(inf._predictor.device), backbone=inf._predictor.model_cfg.backbone)
    assert isinstance(inf._predictor, Predictor)
    (tmp / "port.json").write_text(json.dumps(res, ensure_ascii=False))


def _jax_main(tmp: Path) -> None:
    """The JAX package's pipelines and standalone class on the same files."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from khmer_ocr_tpu.infer.standalone import KhmerOCRInference
    from khmer_ocr_tpu.pipeline.document import run_layout_aware_pipeline
    from khmer_ocr_tpu.pipeline.engine import KhmerOCRPipeline

    rec = str(tmp / "recognizer.safetensors")
    out = {}
    with jax.default_matmul_precision("highest"):
        pipe = KhmerOCRPipeline(engine="custom", layout_model_dir=str(tmp / "layout"), recognizer_model_path=rec)
        out["process_image"] = pipe.process_image(str(tmp / "doc0.png"))
        out["process_pages"] = pipe.process_pages([tmp / f"doc{i}.png" for i in range(N_PAGES)], beam_width=3)
        out["layout_aware"] = run_layout_aware_pipeline(str(tmp / "doc0.png"), model_path=rec, engine="custom",
                                                        layout_model_dir=str(tmp / "layout"))
        lines = real_lines(3)
        for binarize in (False, True):
            inf = KhmerOCRInference(rec, binarize=binarize)
            out[f"standalone/{binarize}"] = dict(predict=[inf.predict(line) for line in lines],
                                                 batch=inf.predict_batch(lines, beam_width=3))
    (tmp / "jax.json").write_text(json.dumps(out, ensure_ascii=False))


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def port(tmp_path_factory):
        """The files, then at once: the port, the JAX package and the two CLIs,
        each in its own process."""
        tmp = tmp_path_factory.mktemp("torch_pipeline")
        subprocess.run([sys.executable, __file__, "save", str(tmp)], cwd=REPO / "tests", check=True, timeout=600)
        (tmp / "pages").mkdir()
        for i in range(N_PAGES):
            (tmp / "pages" / f"doc{i}.png").write_bytes((tmp / f"doc{i}.png").read_bytes())
        rec, layout = str(tmp / "recognizer.safetensors"), str(tmp / "layout")
        font = str(REPO / "khmer_ocr_torch" / "data" / "fonts" / "NotoSansKhmer-Regular.ttf")
        runs = {
            "port": [__file__, "port", str(tmp)], "jax": [__file__, "jax", str(tmp)],
            "pdf": ["-m", "khmer_ocr_torch.pipeline.pdf", "--image", str(tmp / "doc0.png"), "--model", rec, "--font",
                    font, "--engine", "custom", "--layout-model", layout, "--outdir", str(tmp / "pdf"),
                    "--device", "cpu"],
            "pipeline": ["-m", "khmer_ocr_torch.pipeline.engine", "--image", str(tmp / "pages"), "--engine", "custom",
                         "--layout-model", layout, "--recognizer", rec, "--beam", "3", "--output",
                         str(tmp / "texts"), "--device", "cpu"]}
        procs = {name: subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True) for name, argv in runs.items()}
        done = {name: (proc, *proc.communicate(timeout=600)) for name, proc in procs.items()}
        for name in ("port", "jax"):
            assert done[name][0].returncode == 0, done[name][2][-3000:]
        return tmp, json.loads((tmp / "port.json").read_text()), done

    @pytest.fixture(scope="module")
    def jax_fake(tmp_path_factory):
        from khmer_ocr_tpu.pipeline import engine

        saved = engine.recognize_batch
        try:
            return fake_scenarios(engine, tmp_path_factory.mktemp("jax_fake"))
        finally:
            engine.recognize_batch = saved

    @pytest.mark.parametrize("scenario", ["wiring", "pipelined", "accumulated", "worker_error"])
    def test_pipeline_wiring_equals_jax(port, jax_fake, scenario):
        assert port[1]["fake"][scenario] == jax_fake[scenario]

    def test_pipeline_wiring_values(port):
        fake = port[1]["fake"]
        assert fake["wiring"]["text"] == fake["wiring"]["file"] == "L0\nL1"
        assert fake["wiring"]["sizes"][0] == [202, 42]  # the header (y=20) first, padded by 6; the picture dropped
        assert fake["pipelined"]["calls"] == [6, 9] and fake["pipelined"]["threads"] == ["khmer-ocr-detect"]
        assert fake["pipelined"]["texts"][1] == "L1\nL2" and fake["pipelined"]["files"] == fake["pipelined"]["texts"]
        assert fake["accumulated"]["calls"] == [6 * 18]
        assert fake["worker_error"] == "RuntimeError: detector exploded"

    @pytest.fixture(scope="module")
    def jax_real(port):
        return json.loads((port[0] / "jax.json").read_text())

    @pytest.mark.parametrize("entry", ["process_image", "process_pages", "layout_aware"])
    def test_pipelines_equal_jax(port, jax_real, entry):
        assert port[1][entry] == jax_real[entry]
        assert port[1][entry]

    @pytest.mark.parametrize("binarize", [False, True])
    def test_standalone_equals_jax(port, jax_real, binarize):
        got, want = port[1][f"standalone/{binarize}"], jax_real[f"standalone/{binarize}"]
        assert got["predict"] == want["predict"] and got["batch"] == want["batch"]
        assert got["caps"] == [128, 128, 128, None]  # predict's cap is 128; predict_batch keeps the model's
        assert got["binarize"] is binarize and got["device"] == "cpu" and got["backbone"] == "se_vgg"

    def test_pdf_cli_on_the_cpu(port):
        from khmer_ocr_torch.pipeline.minipdf import extract_pdf_text

        tmp, res, cli = port
        assert cli["pdf"][0].returncode == 0, cli["pdf"][2][-2000:]
        pdf = tmp / "pdf" / "doc0_final.pdf"
        assert pdf.read_bytes().startswith(b"%PDF-")
        assert extract_pdf_text(pdf) == [r["text"] for r in res["layout_aware"] if r["text"]]

    def test_pipeline_cli_on_the_cpu(port):
        tmp, res, cli = port
        assert cli["pipeline"][0].returncode == 0, cli["pipeline"][2][-2000:]
        assert [(tmp / "texts" / f"doc{i}.txt").read_text() for i in range(N_PAGES)] == res["process_pages"]

    # --- the host-only pieces, both packages in this process ------------------

    def test_center_containment_and_block_assignment():
        from khmer_ocr_torch.pipeline import document as port_doc
        from khmer_ocr_tpu.pipeline import document as jax_doc

        assert port_doc.get_center([0, 0, 10, 20]) == jax_doc.get_center([0, 0, 10, 20]) == (5, 10)
        for inner in ([2, 2, 8, 8], [12, 2, 20, 8], [0, 0, 20, 20]):
            assert port_doc.is_center_inside(inner, [0, 0, 10, 10]) == jax_doc.is_center_inside(inner, [0, 0, 10, 10])
        rs = np.random.RandomState(0)
        lines = [[int(x), int(y), int(x) + 80, int(y) + 10] for x, y in rs.randint(0, 300, (12, 2))]
        blocks = [("Text", [0, 0, 150, 150]), ("Title", [100, 100, 400, 200]), ("Picture", [0, 200, 200, 400])]
        got = port_doc.assign_lines_to_blocks(lines, blocks)
        assert got == jax_doc.assign_lines_to_blocks(lines, blocks)
        assert got[-1]["type"] == "Orphan"

    @pytest.mark.parametrize("args", [([50, 40, 150, 60], 5, 10), ([0, 0, 30, 30], 8, 0), ([190, 90, 200, 100], 5, 3)])
    def test_crop_with_padding_equals_jax(args):
        from PIL import Image

        from khmer_ocr_torch.pipeline.document import crop_with_padding
        from khmer_ocr_tpu.pipeline.document import crop_with_padding as jax_crop

        img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (100, 200), np.uint8))
        bbox, expansion, padding = args
        got, want = crop_with_padding(img, bbox, expansion, padding), jax_crop(img, bbox, expansion, padding)
        assert got.size == want.size and got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("text,w,h", [("ខ្មែរ", 120, 30), ("ភាសាខ្មែរ ១២៣", 300, 24), ("", 40, 12)])
    def test_text_stamp_equals_jax(text, w, h):
        from khmer_ocr_torch.data.generator import find_fonts
        from khmer_ocr_torch.pipeline.pdf import create_high_res_text_stamp
        from khmer_ocr_tpu.pipeline.pdf import create_high_res_text_stamp as jax_stamp

        font = str(find_fonts(None)[0])
        got, want = create_high_res_text_stamp(text, w, h, font), jax_stamp(text, w, h, font)
        assert got.size == want.size == (3 * w, 3 * h) and got.mode == "RGBA"
        assert got.tobytes() == want.tobytes()

    @pytest.fixture(scope="module")
    def known_page(tmp_path_factory):
        """Page 0 of the golden document with its known lines and the
        flagship's strings of them."""
        tmp = tmp_path_factory.mktemp("known_page")
        meta = json.loads((REPO / "khmer_ocr_torch" / "assets" / "document_golden.json").read_text())
        page_images()[0].save(tmp / "page.png")
        items = [{"text": t, "bbox": box} for t, (box, _) in
                 zip(meta["crop_strings"], sorted(meta["known_elements"][0], key=lambda e: e[0][1]))]
        return tmp, items

    @pytest.mark.parametrize("font", ["Bokor-Regular.ttf", "NotoSansKhmer-Regular.ttf"])
    def test_searchable_pdf_equals_jax_byte_for_byte(known_page, tmp_path, font):
        from khmer_ocr_torch.pipeline.minipdf import extract_pdf_text
        from khmer_ocr_torch.pipeline.pdf import generate_searchable_pdf
        from khmer_ocr_tpu.pipeline.pdf import generate_searchable_pdf as jax_pdf

        page, items = known_page
        font_path = REPO / "khmer_ocr_torch" / "data" / "fonts" / font
        got = generate_searchable_pdf(page / "page.png", items, tmp_path / "port.pdf", font_path)
        want = jax_pdf(page / "page.png", items, tmp_path / "jax.pdf", font_path)
        assert got.read_bytes() == want.read_bytes()
        assert extract_pdf_text(got) == [i["text"] for i in items]

    def test_text_extractor_reads_streams_by_length(known_page, tmp_path):
        """NotoSansKhmer's ToUnicode stream for these 16 lines compresses to
        bytes ending in a carriage return, which JAX's extractor drops."""
        import zlib

        from khmer_ocr_torch.pipeline.minipdf import extract_pdf_text
        from khmer_ocr_torch.pipeline.pdf import generate_searchable_pdf
        from khmer_ocr_tpu.pipeline.minipdf import extract_pdf_text as jax_extract

        page, items = known_page
        pdf = generate_searchable_pdf(page / "page.png", items, tmp_path / "p.pdf",
                                      REPO / "khmer_ocr_torch" / "data" / "fonts" / "NotoSansKhmer-Regular.ttf")
        assert extract_pdf_text(pdf) == [i["text"] for i in items]
        with pytest.raises(zlib.error):
            jax_extract(pdf)

    def test_surya_engine_is_gated():
        from khmer_ocr_torch.detection import surya

        surya._PREDICTOR = None
        with pytest.raises(ImportError, match="surya-ocr is not installed"):
            surya.run_textline_detector(page_images()[0])

    @pytest.mark.parametrize("case", [
        dict(bboxes=[(10, 20, 110, 40)]), dict(bboxes=[(5, 5, 50, 20), (100, 40, 118, 58)], expansion_px=10),
        dict(bboxes=[(10, 10, 60, 30)], padding_px=7), dict(bboxes=[(50, 50, 50, 60), (30, 30, 20, 40), (10, 10, 40, 20)]),
        dict(bboxes=[(10, 70, 80, 90), (10, 10, 80, 30), (10.9, 40.7, 80.2, 60.99)], expansion_px=3, padding_px=2)])
    def test_surya_crop_geometry_equals_jax(case):
        from PIL import Image

        from khmer_ocr_torch.detection.surya import extract_textline_crops
        from khmer_ocr_tpu.detection.surya import extract_textline_crops as jax_crops

        class Line:
            def __init__(self, bbox):
                self.bbox = bbox

        class Prediction:
            def __init__(self, bboxes):
                self.bboxes = [Line(b) for b in bboxes]

        img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (100, 200, 3), np.uint8))
        kw = {k: v for k, v in case.items() if k != "bboxes"}
        got = extract_textline_crops(img, Prediction(case["bboxes"]), **kw)
        want = jax_crops(img, Prediction(case["bboxes"]), **kw)
        assert [b for _, b in got] == [b for _, b in want]
        assert [c.tobytes() for c, _ in got] == [c.tobytes() for c, _ in want]


if __name__ == "__main__":
    {"save": _save_main, "port": _port_main, "jax": _jax_main}[sys.argv[1]](Path(sys.argv[2]))

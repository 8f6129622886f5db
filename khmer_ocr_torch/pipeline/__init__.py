"""Document pipelines: ``KhmerOCRPipeline`` (page images to text, with the
pipelined multi-page ``process_pages``), the layout-aware document pipeline
and the searchable PDF with its pure-Python writer."""

from .._exports import lazy_getattr

__all__ = ["KhmerOCRPipeline"]
__getattr__ = lazy_getattr(__name__, {"KhmerOCRPipeline": "engine"})

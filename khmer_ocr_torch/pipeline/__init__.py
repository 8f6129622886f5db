"""Document pipelines: ``KhmerOCRPipeline`` (page images to text, with the
pipelined multi-page ``process_pages``), the layout-aware document pipeline
and the searchable PDF with its pure-Python writer."""

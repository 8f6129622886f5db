"""Layout detection: the SegFormer (MiT-b0) layout model, its classical-CV
post-process, ``LayoutInference`` and the layout CLI; the import-gated Surya
text-line engine."""

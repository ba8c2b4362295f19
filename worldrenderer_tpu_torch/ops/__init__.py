"""Rasterizer ops of the PyTorch port: setup and binning
(``rasterize``), the fused G-buffer path (``gbuffer``) and its CUDA kernel
(``gbuffer_cuda``, built by ``_build``)."""

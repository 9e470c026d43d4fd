"""DAIN — depth-aware video frame interpolation, in PyTorch.

Counterpart of ``meta_interpolation_tpu/models/dain/``:
  * hourglass.py — MegaDepth HourGlass depth net, from hourglass_spec.json
  * s2df.py      — S2DF_3dense context features
  * pwcnet.py    — PWC-DC optical flow (+ ops/correlation.py)
  * mononet.py   — MonoNet5 adaptive-filter encoder-decoder
  * rectify.py   — MultipleBasicBlock_4, the only meta-learned part
  * model.py     — the composed forward
"""

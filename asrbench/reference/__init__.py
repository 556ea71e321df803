"""The plain reference of the benchmark: Qwen3-ASR-0.6B and
Qwen3-ForcedAligner-0.6B in float32 PyTorch, with TF32 off.

It follows the published description of the two models (the Whisper-style
audio tower and the Qwen3 decoder) with no kernel, no KV cache and no
batching, and takes nothing the measured program made: the benchmark hands
it the same dense weights and PCM it handed the program, and it builds the
log-mel, the prompts and the logits itself. It imports neither JAX, the JAX
package nor the PyTorch port.

Departures from the published description, each the way the measured
system runs the model (so a reading is a gap of precision, not of design):
- the ASR tower attends over the whole utterance (the published config
  lists windows of `n_window_infer` frames, which only the aligner's tower
  applies, in windows of 13 * n_window_infer / 100 rows);
- the log-mel takes the frame count n // 160, dropping the last frame of
  the centred STFT, as the GGML reference does;
- the vocabulary is a byte vocabulary (random weights; no tokenizer file).
"""

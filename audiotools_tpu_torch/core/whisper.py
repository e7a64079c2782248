"""Whisper mixin: features, transcripts and embeddings through HF
transformers.

Counterpart of ``audiotools_tpu/core/whisper.py``. ``transformers`` is
imported where the model is set up, not with the module. The model goes
to the signal's device unless ``setup_whisper`` is given one; the
feature extractor is numpy, so the resampled audio comes to the host for
it and its features go to the model's device.

.. warning:: **Experimental.** No weights ship with the package, and its
   tests run the whole path (``from_pretrained`` -> resample -> feature
   extraction -> ``generate`` -> decode -> encoder embeddings) against a
   tiny random-weight checkpoint built offline
   (tests/test_torch_presentation.py); the content of transcripts from
   pretrained weights is unverified here.
"""
import warnings


class WhisperMixin:
    is_initialized = False

    def setup_whisper(self, pretrained_model_name_or_path: str = "openai/whisper-base.en",
                      device: str = None):
        from transformers import WhisperForConditionalGeneration, WhisperProcessor

        warnings.warn(
            "WhisperMixin is experimental: its plumbing is tested against a "
            "random-weight checkpoint, but not with pretrained Whisper weights. "
            "Verify transcript content before relying on it.",
            stacklevel=2,
        )
        self.whisper_device = self.device if device is None else device
        name = pretrained_model_name_or_path
        self.whisper_processor = WhisperProcessor.from_pretrained(name)
        model = WhisperForConditionalGeneration.from_pretrained(name)
        self.whisper_model = model.to(self.whisper_device)
        self.is_initialized = True

    def get_whisper_features(self):
        """Whisper input features of the signal's first channel, on the
        host (the feature extractor's output)."""
        import torch

        if not self.is_initialized:
            self.setup_whisper()

        target_sr = self.whisper_processor.feature_extractor.sampling_rate
        resampled = self.clone().resample(target_sr)
        raw_speech = list(resampled.audio_data[:, 0, :].detach().cpu().numpy())

        with torch.inference_mode():
            input_features = self.whisper_processor(
                raw_speech, sampling_rate=target_sr, return_tensors="pt",
            ).input_features

        return input_features

    def get_whisper_transcript(self) -> str:
        """Transcript of the first item."""
        import torch

        if not self.is_initialized:
            self.setup_whisper()

        input_features = self.get_whisper_features()

        with torch.inference_mode():
            input_features = input_features.to(self.whisper_device)
            generated_ids = self.whisper_model.generate(input_features=input_features)

        transcription = self.whisper_processor.batch_decode(generated_ids)
        return transcription[0]

    def get_whisper_embeddings(self):
        """The encoder's last hidden state, on the model's device."""
        import torch

        if not self.is_initialized:
            self.setup_whisper()

        features = self.get_whisper_features().to(self.whisper_device)
        with torch.inference_mode():
            encoded = self.whisper_model.get_encoder()(features)
        return encoded.last_hidden_state

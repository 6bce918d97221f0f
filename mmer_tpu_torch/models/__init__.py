"""The clip-path models: ViViT, Wav2Vec2 and the fusion model."""

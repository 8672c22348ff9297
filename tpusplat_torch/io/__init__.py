"""Scene and image IO."""

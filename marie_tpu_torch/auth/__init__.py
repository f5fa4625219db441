from marie_tpu_torch.auth.api_key_manager import APIKeyManager, auth_enabled, validate_bearer

__all__ = ["APIKeyManager", "auth_enabled", "validate_bearer"]

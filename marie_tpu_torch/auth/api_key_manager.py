"""API-key auth (copy of ``marie_tpu/auth/api_key_manager.py``): ``mas_``
keys declared in configuration, validated per request."""

import secrets
from typing import Dict, List, Optional


class APIKeyManager:
    _keys: Dict[str, Dict] = {}

    @classmethod
    def from_config(cls, config: List[Dict]) -> None:
        """Load keys from an auth config: [{name, api_key, enabled, roles}]."""
        for item in config or []:
            key = item.get("api_key")
            if key:
                cls._keys[key] = {
                    "name": item.get("name", "unnamed"),
                    "enabled": item.get("enabled", True),
                    "roles": item.get("roles", []),
                }

    @classmethod
    def add_key(cls, name: str, roles: Optional[List[str]] = None) -> str:
        """Generate and register a new service key."""
        key = "mas_" + secrets.token_urlsafe(24)
        cls._keys[key] = {"name": name, "enabled": True, "roles": roles or []}
        return key

    @classmethod
    def is_valid(cls, api_key: Optional[str]) -> bool:
        if not api_key:
            return False
        info = cls._keys.get(api_key)
        return bool(info and info.get("enabled"))

    @classmethod
    def name_for(cls, api_key: str) -> Optional[str]:
        info = cls._keys.get(api_key)
        return info["name"] if info else None

    @classmethod
    def clear(cls) -> None:
        cls._keys.clear()

    @classmethod
    def enabled(cls) -> bool:
        """Auth is enforced as soon as any key is configured."""
        return bool(cls._keys)


def auth_enabled() -> bool:
    return APIKeyManager.enabled()


def validate_bearer(header_value: Optional[str]) -> bool:
    """``Authorization: Bearer <key>`` guard.

    When no keys are configured, auth is disabled and every request
    passes.
    """
    if not APIKeyManager.enabled():
        return True
    if not header_value or not header_value.startswith("Bearer "):
        return False
    return APIKeyManager.is_valid(header_value[len("Bearer ") :].strip())

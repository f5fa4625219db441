"""Entity validators (copy of
``marie_tpu/components/document_indexer/validator.py``): ``validate``
returns a normalized value or raises ``ValueError`` with a description.
Dates, amounts, phone numbers and a structural US-address parser.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from datetime import datetime
from decimal import Decimal, InvalidOperation
from typing import Any, Dict, Optional


class EntityValidator(ABC):
    @abstractmethod
    def validate(self, value: Any) -> Any:
        """Return the normalized value; raise ValueError when invalid."""

    def __call__(self, value: str) -> Any:
        return self.validate(value)


class DateValidator(EntityValidator):
    """Accepts common US/ISO date spellings; normalizes to YYYY-MM-DD."""

    FORMATS = (
        "%m/%d/%Y", "%m/%d/%y", "%m-%d-%Y", "%m-%d-%y",
        "%Y-%m-%d", "%Y/%m/%d", "%b %d, %Y", "%B %d, %Y",
        "%d %b %Y", "%d %B %Y", "%m.%d.%Y",
    )

    def validate(self, value: Any) -> str:
        if not isinstance(value, str):
            raise ValueError(f"Expected a string, but got {value!r}")
        text = value.strip()
        for fmt in self.FORMATS:
            try:
                return datetime.strptime(text, fmt).date().isoformat()
            except ValueError:
                continue
        raise ValueError(f"Unable to parse date: {value!r}")


class AmountValidator(EntityValidator):
    """Monetary amounts; normalizes to a Decimal string with 2 places."""

    PATTERN = re.compile(
        r"^\(?\s*[$€£]?\s*(\d{1,3}(?:,\d{3})*|\d+)(\.\d{1,4})?\s*\)?$"
    )

    def validate(self, value: Any) -> str:
        if not isinstance(value, str):
            raise ValueError(f"Expected a string, but got {value!r}")
        text = value.strip()
        negative = text.startswith("(") and text.endswith(")")
        # accounting negatives need BOTH parentheses — an unbalanced
        # '(42.00' must be rejected, not parsed as positive 42.00
        if text.startswith("(") != text.endswith(")"):
            raise ValueError(f"Unable to parse amount: {value!r}")
        m = self.PATTERN.match(text)
        if not m:
            raise ValueError(f"Unable to parse amount: {value!r}")
        digits = m.group(1).replace(",", "") + (m.group(2) or "")
        try:
            amount = Decimal(digits)
        except InvalidOperation as e:  # pragma: no cover — regex guards
            raise ValueError(f"Unable to parse amount: {value!r}") from e
        if negative:
            amount = -amount
        return f"{amount:.2f}"


class PhoneValidator(EntityValidator):
    """US phone numbers; normalizes to digits (optionally +1-stripped)."""

    def validate(self, value: Any) -> str:
        if not isinstance(value, str):
            raise ValueError(f"Expected a string, but got {value!r}")
        digits = re.sub(r"\D", "", value)
        if len(digits) == 11 and digits.startswith("1"):
            digits = digits[1:]
        if len(digits) != 10:
            raise ValueError(f"Unable to parse phone number: {value!r}")
        return digits


class AddressValidator(EntityValidator):
    """Structural US-address check: street line + city/state/zip tail.

    Same contract as the reference's usaddress-backed validator —
    returns a component dict or raises ValueError.
    """

    STATE = (
        "AL AK AZ AR CA CO CT DE FL GA HI ID IL IN IA KS KY LA ME MD MA "
        "MI MN MS MO MT NE NV NH NJ NM NY NC ND OH OK OR PA RI SC SD TN "
        "TX UT VT VA WA WV WI WY DC"
    ).split()
    TAIL = re.compile(
        r"(?P<city>[A-Za-z .'-]+?)[,\s]+(?P<state>[A-Za-z]{2})\s+"
        r"(?P<zip>\d{5}(?:-\d{4})?)\s*$"
    )
    STREET = re.compile(r"^\s*(?P<number>\d+[A-Za-z]?)\s+(?P<street>.+)")

    def validate(self, value: Any) -> Dict[str, str]:
        if not isinstance(value, str):
            raise ValueError(f"Expected a string, but got {value!r}")
        text = " ".join(value.split())
        tail = self.TAIL.search(text)
        if not tail:
            raise ValueError(f"Unable to parse address (no city/state/zip): {value!r}")
        state = tail.group("state").upper()
        if state not in self.STATE:
            raise ValueError(f"Unable to parse address (unknown state {state}): {value!r}")
        head = text[: tail.start()].strip(" ,")
        street = self.STREET.match(head)
        if not street:
            raise ValueError(f"Unable to parse address (no street number): {value!r}")
        return {
            "address1": f"{street.group('number')} {street.group('street').strip(' ,')}",
            "city": tail.group("city").strip(" ,"),
            "state": state,
            "zip_code": tail.group("zip"),
        }


_REGISTRY: Dict[str, EntityValidator] = {}


def register_validator(label: str, validator: EntityValidator) -> None:
    _REGISTRY[label.upper()] = validator


def get_validator(label: str) -> Optional[EntityValidator]:
    return _REGISTRY.get(label.upper())


for _label in ("DATE", "DOS", "DOB", "CHECK_DATE", "BILLED_DATE"):
    register_validator(_label, DateValidator())
for _label in ("AMOUNT", "TOTAL", "PAID_AMT", "BILLED_AMT", "CHECK_AMT"):
    register_validator(_label, AmountValidator())
for _label in ("PHONE", "FAX"):
    register_validator(_label, PhoneValidator())
register_validator("ADDRESS", AddressValidator())
